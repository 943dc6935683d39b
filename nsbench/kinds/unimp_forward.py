"""``"kind": "unimp_forward"``: closed-loop full-graph forwards of UniMP
(Shi et al. 2021), built from the program's ``models.UniMP`` over its
``GraphTransformerConv`` layers: per layer one fused projection GEMM, one
``sparse.sddmm`` batched over the heads, the edge softmax, and per head one
``with_values`` and one ``sparse.spmm``; LayerNorm and ReLU between
layers; the masked label embedding on the input.  Inference: no gradient,
no dropout, every training node's label given.

The configuration gives ``features``, ``classes``, ``train_nodes`` and
``unimp`` (``num_layers``, ``heads``, ``hidden``); the mix gives ``pool``
(seeded feature matrices), ``in_flight`` (forwards on the device at
most), ``warmup_forwards`` and ``check_forwards`` (the forwards kept, a
reservoir sample over the window's drawn from the seed, each one's logits
compared).  The first layer's attention weights of a warm-up forward on
the pool's first input are compared too.

``FAULTS``:

- ``stale_values``: ``with_values`` hands back the matrix as it was, so
  every SpMM runs on the plan's old values;
- ``no_gate``: the program's gates read zero weights, so β is ½.
"""
import contextlib
import random
import time
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from nsbench import counts, counts_attention, drive, reference_unimp
from nsbench.reference import finite


def known_nodes(cfg: dict, n: int, device: torch.device) -> torch.Tensor:
    """The training nodes, whose labels the embedding adds: fixed by the
    graph's seed, as ``gcn_full_batch`` draws its split."""
    split = np.random.RandomState(cfg["graph"]["seed"] + 1).permutation(n)
    return torch.from_numpy(np.sort(split[:cfg["train_nodes"]])).to(device)


def feature_pool(cfg: dict, mix: dict, n: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """(pool, n, features), standard normal from the seed, in one draw."""
    return torch.randn((mix["pool"], n, cfg["features"]),
                       generator=drive.generator(device, seed + 1),
                       device=device)


def weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, object]:
    """The model's weights from the seed, as PyTorch Geometric initialises
    them: each layer's fused ``[W_q | W_k | W_v | W_r]`` and its bias
    U(±1/√d_in), the gate U(±1/√(3R)), the label embedding standard
    normal, the norms' weight one and bias zero."""
    gen = drive.generator(device, seed + 4)

    def uniform(shape, fan_in):
        bound = 1.0 / float(np.sqrt(fan_in))
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
            * bound

    layers, norms = [], []
    specs = counts_attention.unimp_layers(cfg)
    for i, (d_in, heads, c, concat) in enumerate(specs):
        root = heads * c if concat else c
        width = 3 * heads * c + root
        layers.append({"weight": uniform((d_in, width), d_in),
                       "bias": uniform((width,), d_in),
                       "w_beta": uniform((3 * root,), 3 * root),
                       "heads": heads, "concat": concat, "root": root})
        if i < len(specs) - 1:
            norms.append((torch.ones(root, device=device),
                          torch.zeros(root, device=device)))
    emb = torch.randn((cfg["classes"], cfg["features"]), generator=gen,
                      device=device)
    return {"emb": emb, "layers": layers, "norms": norms}


def model_of(a, w: Dict[str, object]) -> nn.Module:
    """The program's UniMP over graph ``a`` with weights ``w``."""
    from repro_torch.models import GraphTransformerConv, UniMP

    convs = [GraphTransformerConv(a, p["weight"], p["bias"],
                                  heads=p["heads"], concat=p["concat"],
                                  root=p["root"], w_beta=p["w_beta"])
             for p in w["layers"]]
    dev = w["emb"].device
    norms = []
    for nw, nb in w["norms"]:
        norm = nn.LayerNorm(nw.numel(), device=dev)
        with torch.no_grad():
            norm.weight.copy_(nw)
            norm.bias.copy_(nb)
        norms.append(norm)
    emb = nn.Embedding.from_pretrained(w["emb"].clone(), freeze=True)
    return UniMP(emb, convs, norms).eval()


class Load(drive.Load):

    def setup(self) -> None:
        # a program without the model fails here, before the graph is built
        from repro_torch.models import UniMP  # noqa: F401

        cfg, dev = self.cfg, self.device
        labels = self.prepare()
        n = labels.size
        self.labels = torch.from_numpy(labels).long().to(dev)
        self.known = known_nodes(cfg, n, dev)
        self.w = weights(cfg, self.seed, dev)
        self.pool = feature_pool(cfg, self.mix, n, self.seed, dev)
        heads = counts_attention.unimp_heads(cfg)
        layers = [(h, c) for _, h, c, _ in counts_attention.unimp_layers(cfg)]
        self.counters.update(
            forward_flops=counts_attention.unimp_spmm_flops(
                self.counters["nnz"], heads),
            sddmm_bound_s=counts_attention.unimp_sddmm_bound_s(
                n, self.counters["nnz"], layers))
        self.model = model_of(self.a, self.w)
        with torch.no_grad():
            for i in range(self.mix["warmup_forwards"]):
                self._forward(i % self.mix["pool"])
            # the first layer's attention weights, as the forward computes
            # them, on the pool's first input
            x0 = self.pool[0].index_add(
                0, self.known, self.model.label_emb(self.labels[self.known]))
            self.alpha = self.model.convs[0].edge_scores(x0)
        drive.sync(dev)

    def _forward(self, b: int) -> torch.Tensor:
        return self.model(self.pool[b], self.labels, self.known)

    def window(self, seconds: float) -> Dict[str, float]:
        depth, keep = self.mix["in_flight"], self.mix["check_forwards"]
        pick = random.Random(self.seed)
        self.kept: List[Tuple[int, torch.Tensor]] = []
        inflight: deque = deque()
        cuda = self.device.type == "cuda"
        forwards = 0
        with torch.no_grad():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                b = forwards % self.mix["pool"]
                with self.rec.span("dispatch"):
                    z = self._forward(b)
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    inflight.append(ev)
                    if len(inflight) >= depth:
                        inflight.popleft().synchronize()
                # reservoir sample of the forwards' logits
                if forwards < keep:
                    self.kept.append((b, z))
                else:
                    j = pick.randrange(forwards + 1)
                    if j < keep:
                        self.kept[j] = (b, z)
                forwards += 1
            drive.sync(self.device)
            window_s = time.perf_counter() - t0
        self.attempted = forwards
        self.failed += sum(not bool(torch.isfinite(z).all())
                           for _, z in self.kept)
        self.counters.update(forwards=forwards, window_s=window_s)
        return {"spmm_gflops": counts.gflops(self.counters["forward_flops"],
                                             forwards, window_s)}

    def release(self) -> None:
        self.model = None
        super().release()

    def check(self, limits: Dict[str, float]) -> Dict[str, float]:
        rows, cols, _, shape = self.coo
        graph = reference_unimp.Graph(rows, cols, shape[0], self.device)
        worst = 0.0
        alpha_ref = None
        for b in sorted({b for b, _ in self.kept} | {0}):
            ref, a = reference_unimp.forward(
                graph, self.pool[b], self.labels, self.known, self.w,
                want_alpha=b == 0)
            if b == 0:
                alpha_ref = a
            for bb, z in self.kept:
                if bb == b:
                    gap = rel_gap(z, ref)
                    worst = max(worst, gap)
                    self.failed += gap > limits["logits_gap"]
        return {"logits_gap": worst,
                "alpha_gap": alpha_gap(self.alpha, alpha_ref)}


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ in float64, NaN read as unbounded."""
    return finite((got.double() - want).norm() / want.norm())


def alpha_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst head's ‖α − α_ref‖ / ‖α_ref‖."""
    return max(rel_gap(g, w) for g, w in zip(got, want))


def control(bench, cfg: dict, mix: dict, seed: int,
            device: torch.device) -> Dict[str, float]:
    """The TF32 control's numbers: its forward on the pool's first input
    against the float64 reference's."""
    rows, cols, _, shape, labels = drive.build_graph(bench, cfg, seed,
                                                     device)
    n = shape[0]
    graph = reference_unimp.Graph(rows, cols, n, device)
    y = torch.from_numpy(labels).long().to(device)
    known = known_nodes(cfg, n, device)
    w = weights(cfg, seed, device)
    x = feature_pool(cfg, mix, n, seed, device)[0]
    ref, a_ref = reference_unimp.forward(graph, x, y, known, w,
                                         want_alpha=True)
    ctl, a_ctl = reference_unimp.forward(graph, x, y, known, w, tf32=True,
                                         want_alpha=True)
    return {"logits_gap": rel_gap(ctl, ref),
            "alpha_gap": alpha_gap(a_ctl, a_ref)}


@contextlib.contextmanager
def _stale_values():
    import repro_torch.sparse as sp

    real = sp.SparseMatrix.with_values
    sp.SparseMatrix.with_values = lambda self, values: self
    try:
        yield
    finally:
        sp.SparseMatrix.with_values = real


@contextlib.contextmanager
def _no_gate():
    real = globals()["model_of"]

    def gateless(a, w):
        model = real(a, w)
        with torch.no_grad():
            for conv in model.convs:
                conv.w_beta.zero_()
        return model

    globals()["model_of"] = gateless
    try:
        yield
    finally:
        globals()["model_of"] = real


FAULTS = {"stale_values": _stale_values, "no_gate": _no_gate}
