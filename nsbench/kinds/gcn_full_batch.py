"""``"kind": "gcn_full_batch"``: full-batch training epochs of OGB's GCN
baseline built from the program's graph layer (``SparseGraphConv``, every
aggregation a coordinated SpMM, its backward through the transpose plan):
for each layer ``A @ (H W) + b``, on every layer but the last batch norm,
ReLU and dropout, then the log-probabilities; Adam over all parameters;
the mean negative log-likelihood of the training nodes; ``loss.item()``
each epoch, as OGB's loop reads it.

The configuration gives ``features``, ``hidden``, ``classes``,
``num_layers``, ``dropout``, ``lr`` and ``train_nodes``; the mix gives
``warmup_steps`` and ``checked_steps``.  The first ``checked_steps`` of
the warm-up run through the window's own call on the one model and
optimizer that the window then goes on with; the reference follows them.

``FAULTS``:

- ``unchanged``: the step computes its loss and gradients and leaves the
  parameters and the optimizer as they were;
- ``half_batch``: the loss taken over the first half of the training
  nodes only;
- ``altered``: one entry of every SpMM's output changed by +1, in the
  forward and the backward.
"""
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nsbench import counts, drive, faults, reference

BETA1 = 0.9  # Adam's default, as OGB uses it


def widths(cfg: dict) -> List[int]:
    return ([cfg["features"]] + [cfg["hidden"]] * (cfg["num_layers"] - 1)
            + [cfg["classes"]])


def inputs(cfg: dict, labels: np.ndarray, seed: int, device: torch.device):
    """``(x, y, train_idx, leaves)`` from the seed, drawn on the device:
    features standard normal plus 0.4 on each node's label column, the
    labels, the training nodes (fixed by the graph's seed, as a split
    is), and the initial parameters in the order of ``reference.gcn_forward``
    (W Glorot-uniform as OGB's ``GCNConv``, b zero; the batch norms'
    weight one and bias zero)."""
    n = labels.size
    gen = drive.generator(device, seed + 2)
    x = torch.randn((n, cfg["features"]), generator=gen, device=device)
    y = torch.from_numpy(labels).long().to(device)
    x[torch.arange(n, device=device), y] += 0.4
    split = np.random.RandomState(cfg["graph"]["seed"] + 1).permutation(n)
    train_idx = torch.from_numpy(np.sort(split[:cfg["train_nodes"]])) \
        .to(device)
    d = widths(cfg)
    u = torch.rand(sum(a * b for a, b in zip(d, d[1:])), generator=gen,
                   device=device)
    leaves, at = [], 0
    for layer, (din, dout) in enumerate(zip(d, d[1:])):
        bound = math.sqrt(6.0 / (din + dout))
        w = u[at:at + din * dout].view(din, dout) * (2 * bound) - bound
        at += din * dout
        leaves += [w, torch.zeros(dout, device=device)]
        if layer < len(d) - 2:
            leaves += [torch.ones(dout, device=device),
                       torch.zeros(dout, device=device)]
    return x, y, train_idx, leaves


class Gcn(nn.Module):
    """OGB's GCN on the program's ``SparseGraphConv`` layers."""

    def __init__(self, a, leaves: List[torch.Tensor]):
        from repro_torch.models import SparseGraphConv

        super().__init__()
        n_layers = (len(leaves) + 2) // 4
        self.convs = nn.ModuleList()
        self.biases = nn.ParameterList()
        self.bns = nn.ModuleList()
        i = 0
        for layer in range(n_layers):
            self.convs.append(SparseGraphConv(a, leaves[i].clone()))
            self.biases.append(nn.Parameter(leaves[i + 1].clone()))
            i += 2
            if layer < n_layers - 1:
                bn = nn.BatchNorm1d(leaves[i].numel(),
                                    device=leaves[i].device)
                with torch.no_grad():
                    bn.weight.copy_(leaves[i])
                    bn.bias.copy_(leaves[i + 1])
                self.bns.append(bn)
                i += 2

    def leaves(self) -> List[torch.Tensor]:
        """The parameters in the order of ``reference.gcn_forward``."""
        out = []
        for layer, (conv, b) in enumerate(zip(self.convs, self.biases)):
            out += [conv.w, b]
            if layer < len(self.bns):
                out += [self.bns[layer].weight, self.bns[layer].bias]
        return out

    def forward(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        for layer, (conv, b) in enumerate(zip(self.convs, self.biases)):
            x = conv(x) + b
            if layer < len(self.bns):
                x = torch.relu(self.bns[layer](x)) * masks[layer]
        return torch.log_softmax(x, dim=-1)


def loss_fn(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.nll_loss(out, labels)


def optimizer_step(opt: torch.optim.Optimizer) -> None:
    opt.step()


def train_step(model: Gcn, opt, x, y, train_idx, masks):
    """One full-batch epoch: the loss (detached, before the update) and
    the log-probabilities."""
    opt.zero_grad(set_to_none=True)
    out = model(x, masks)
    loss = loss_fn(out[train_idx], y[train_idx])
    loss.backward()
    optimizer_step(opt)
    return loss.detach(), out.detach()


class Load(drive.Load):

    def setup(self) -> None:
        cfg = self.cfg
        labels = self.prepare()
        self.x, self.y, self.train_idx, self.leaves0 = inputs(
            cfg, labels, self.seed, self.device)
        self.model = Gcn(self.a, self.leaves0)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg["lr"])
        self.mask_gen = drive.generator(self.device, self.seed + 3)
        self.counters.update(epoch_flops=counts.gcn_epoch_flops(
            labels.size, self.counters["nnz"], widths(cfg))["epoch"])
        self.losses: List[float] = []
        self.out1: Optional[torch.Tensor] = None
        self.grads1: Optional[List[torch.Tensor]] = None
        self.after: List[List[torch.Tensor]] = []
        for step in range(1, self.mix["warmup_steps"] + 1):
            loss, out = self._step()
            loss = loss.item()
            if step > self.mix["checked_steps"]:
                continue
            self.losses.append(loss)
            leaves = self.model.leaves()
            self.after.append([p.detach().clone() for p in leaves])
            if step == 1:
                self.out1 = out.clone()
                # the first gradient as Adam got it: its first moment
                # after one step is (1 - beta1) times the gradient
                state = [self.opt.state.get(p, {}) for p in leaves]
                self.grads1 = (None if not all("exp_avg" in s for s in state)
                               else [s["exp_avg"] / (1 - BETA1)
                                     for s in state])

    def _step(self):
        masks = reference.dropout_masks(
            self.mask_gen, self.cfg["num_layers"] - 1, self.x.shape[0],
            self.cfg["hidden"], self.cfg["dropout"], self.device)
        return train_step(self.model, self.opt, self.x, self.y,
                          self.train_idx, masks)

    def window(self, seconds: float) -> Dict[str, float]:
        epochs: List[float] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            e0 = time.perf_counter()
            with self.rec.span("dispatch"):
                loss, _ = self._step()
            with self.rec.span("loss_item"):
                value = loss.item()
            epochs.append(time.perf_counter() - e0)
            self.failed += not math.isfinite(value)
        window_s = time.perf_counter() - t0
        self.attempted = len(epochs)
        self.counters.update(epochs=len(epochs), window_s=window_s)
        return {"gcn_epoch_ms": 1e3 * window_s / len(epochs),
                "gcn_epoch_p95_ms": 1e3 * counts.p95(epochs)}

    def release(self) -> None:
        self.model = self.opt = None
        super().release()

    def check(self, limits: Dict[str, float]) -> Dict[str, float]:
        ref = _reference(self.coo, self.cfg, self.mix, self.x, self.y,
                         self.train_idx, self.leaves0, self.seed)
        return gaps(self.losses, self.out1, self.grads1, self.leaves0,
                    self.after[-1], ref)


def _reference(coo, cfg, mix, x, y, train_idx, leaves0, seed, tf32=False):
    rows, cols, vals, shape = coo
    a = reference.CooOperator(rows, cols, vals, shape, x.device)
    return reference.gcn_steps(a, a.transpose(), x, y, train_idx, leaves0,
                               seed + 3, cfg["dropout"], cfg["lr"],
                               mix["checked_steps"], tf32)


def gaps(losses, out1, grads1, leaves0, leaves_last,
         ref) -> Dict[str, float]:
    """The numbers the cell is held to:

    - ``loss_gap``: the largest |loss - reference loss| / |reference loss|
      over the checked steps;
    - ``logits_gap``: the first step's log-probabilities, ‖P - P_ref‖ /
      ‖P_ref‖ over every node and class;
    - ``grad_gap``: the first gradient as the optimizer got it, by the
      worst leaf: |‖g‖ - ‖g_ref‖| over the larger of the leaf's and the
      median leaf's reference norm;
    - ``change_gap``: the same for the parameters' change over the
      checked steps.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of both gaps: they move under Adam by round-off
    alone (the biases ahead of a batch norm)."""
    g_norm = [float(t.norm()) for t in ref["grads"]]
    live = [i for i, v in enumerate(g_norm)
            if v >= 1e-3 * float(np.median(g_norm))]

    def worst_leaf(prog, want):
        if prog is None:
            return float("inf")
        want_norm = [float(want[i].norm()) for i in live]
        med = float(np.median(want_norm))
        return max(abs(float(prog[i].double().norm()) - r) / max(r, med)
                   for i, r in zip(live, want_norm))

    change = [b.double() - a.double() for a, b in zip(leaves0, leaves_last)]
    change_ref = [b - a.double() for a, b in zip(leaves0, ref["weights"][-1])]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses,
                                                         ref["losses"]))
    logits_gap = float((out1.double() - ref["out"]).norm()
                       / ref["out"].norm())
    return {"loss_gap": reference.finite(loss_gap),
            "logits_gap": reference.finite(logits_gap),
            "grad_gap": reference.finite(worst_leaf(grads1, ref["grads"])),
            "change_gap": reference.finite(worst_leaf(change, change_ref))}


def control(bench, cfg: dict, mix: dict, seed: int,
            device: torch.device) -> Dict[str, float]:
    """The TF32 control's numbers: its checked steps against the float64
    reference's, on the cell's own inputs."""
    rows, cols, vals, shape, labels = drive.build_graph(bench, cfg, seed,
                                                        device)
    coo = (rows, cols, vals, shape)
    x, y, train_idx, leaves0 = inputs(cfg, labels, seed, device)
    ref = _reference(coo, cfg, mix, x, y, train_idx, leaves0, seed)
    ctl = _reference(coo, cfg, mix, x, y, train_idx, leaves0, seed, True)
    return gaps(ctl["losses"], ctl["out"], ctl["grads"], leaves0,
                ctl["weights"][-1], ref)


def _fault(kind: str):
    if kind == "altered":
        import repro_torch.sparse as sp

        real = sp.spmm

        def altered(a, b, **kw):
            c = real(a, b, **kw)
            return c + faults.one_hot_like(c)
        return faults.patched(sp, "spmm", altered)
    if kind == "half_batch":
        def loss_fn(out, labels):
            half = out.shape[0] // 2
            return F.nll_loss(out[:half], labels[:half])
        return faults.patched(globals(), "loss_fn", loss_fn)
    return faults.patched(globals(), "optimizer_step", lambda opt: None)


FAULTS = {k: (lambda k=k: _fault(k)) for k in ("unchanged", "half_batch",
                                                "altered")}
