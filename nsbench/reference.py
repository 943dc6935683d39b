"""The plain reference: SpMM and OGB's GCN's first training steps in
float64, with plain PyTorch operations.

It imports nothing of the program and takes nothing the program made: it
is handed the COO triplets, the operands, the initial weights and the seed
of the dropout masks that the benchmark drew, and works out everything
else (row order, transpose, gradients, the optimizer's steps) again.
``tf32=True`` computes the same in the precision just below the
configuration's: every operand of every product rounded to TF32 (10
explicit mantissa bits), the control that has to fail the comparison.

SpMM sums each row's products in float64, by rows bucketed by
degree: the rows of one bucket are padded to the bucket's width, gathered
and summed along it, so no row's sum depends on another row's and no
prefix sum grows across rows.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# elements of one gathered (rows, width, N) block: 1 GiB in float64
BLOCK_ELEMENTS = 1 << 27


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, to nearest with ties to even: the
    low 13 of the 23 mantissa bits cleared."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _lower(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """A float64 operand, rounded through TF32 where asked."""
    return to_tf32(x).double() if tf32 else x.double()


class CooOperator:
    """A sparse matrix as sorted COO on a device, multiplied in float64."""

    def __init__(self, rows, cols, vals, shape: Tuple[int, int],
                 device="cpu"):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        order = np.argsort(rows, kind="stable")
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        self.nnz = int(rows.size)
        counts = np.bincount(rows, minlength=self.shape[0])
        self.indptr = np.zeros(self.shape[0] + 1, np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        self.deg = counts
        self.cols = torch.from_numpy(cols[order]).to(self.device)
        self.vals32 = torch.from_numpy(vals[order]).to(self.device)
        self._starts = torch.from_numpy(self.indptr[:-1]).to(self.device)
        self._deg = torch.from_numpy(counts).to(self.device)
        self._buckets = self._make_buckets()

    def transpose(self) -> "CooOperator":
        """Aᵀ, from the triplets (sorted again by the new row)."""
        rows = np.repeat(np.arange(self.shape[0]), self.deg)
        return CooOperator(self.cols.cpu().numpy(), rows,
                           self.vals32.cpu().numpy(),
                           (self.shape[1], self.shape[0]), self.device)

    def _make_buckets(self) -> List[Tuple[int, torch.Tensor]]:
        """Rows with nonzeros grouped by ceil(log2(degree)): (width, rows)."""
        deg = self.deg
        nz = np.nonzero(deg)[0]
        if nz.size == 0:
            return []
        width_log = np.ceil(np.log2(deg[nz])).astype(np.int64)
        out = []
        for w in np.unique(width_log):
            rows = nz[width_log == w]
            out.append((1 << int(w), torch.from_numpy(rows).to(self.device)))
        return out

    def blocks(self, b: torch.Tensor, exact: bool = True, mag: bool = True,
               tf32: bool = False
               ) -> Iterator[Tuple[torch.Tensor, Optional[torch.Tensor],
                                   Optional[torch.Tensor],
                                   Optional[torch.Tensor]]]:
        """Yield ``(rows, R, S, R_lower)`` over blocks of rows, each asked
        for or None: R = A @ B and S = |A| @ |B| at those rows in float64,
        and R_lower the product of the TF32-rounded operands.  Rows with no
        nonzero are not yielded (their rows of R and S are 0)."""
        n = b.shape[1]
        b64 = b.double() if exact or mag else None
        bl = _lower(b, True) if tf32 else None
        v64 = self.vals32.double()
        vl = _lower(self.vals32, True) if tf32 else None
        for width, rows in self._buckets:
            per = max(1, BLOCK_ELEMENTS // (width * max(n, 1)))
            j = torch.arange(width, device=self.device)
            for lo in range(0, rows.numel(), per):
                r = rows[lo:lo + per]
                mask = j[None, :] < self._deg[r][:, None]
                pos = torch.where(mask, self._starts[r][:, None] + j[None, :],
                                  0)
                col = self.cols[pos]
                ref = size = low = None
                if b64 is not None:
                    prod = torch.where(mask, v64[pos], 0.0)[:, :, None] \
                        * b64[col]
                    ref = prod.sum(1) if exact else None
                    size = prod.abs_().sum(1) if mag else None
                    del prod
                if tf32:
                    low = (torch.where(mask, vl[pos], 0.0)[:, :, None]
                           * bl[col]).sum(1)
                yield r, ref, size, low

    def matmul(self, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        """A @ B in float64 (from TF32-rounded operands with ``tf32``)."""
        out = torch.zeros((self.shape[0], b.shape[1]), dtype=torch.float64,
                          device=self.device)
        for r, ref, _, low in self.blocks(b, exact=not tf32, mag=False,
                                          tf32=tf32):
            out[r] = low if tf32 else ref
        return out


def componentwise_errors(op: CooOperator, b: torch.Tensor,
                         outputs: List[torch.Tensor],
                         tf32_control: bool = False
                         ) -> Tuple[List[float], Optional[float]]:
    """For each output C of A @ B (fp32, from the program), the largest
    |C - A @ B| / (|A| @ |B|) over all its entries; where |A| @ |B| is 0,
    any nonzero in C is an unbounded error.  With ``tf32_control`` also the
    same number for the TF32 control in place of C, else None."""
    tiny = torch.finfo(torch.float64).tiny
    worst = [0.0] * len(outputs)
    worst_ctl = 0.0
    covered = torch.zeros(op.shape[0], dtype=torch.bool, device=op.device)
    for r, ref, size, low in op.blocks(b, tf32=tf32_control):
        covered[r] = True
        denom = torch.clamp(size, min=tiny)
        for i, c in enumerate(outputs):
            err = ((c[r].double() - ref).abs() / denom).max()
            worst[i] = max(worst[i], finite(err))
        if low is not None:
            worst_ctl = max(worst_ctl,
                            finite(((low - ref).abs() / denom).max()))
    # rows with no nonzero: the program has to give exact zeros there
    for i, c in enumerate(outputs):
        if bool((c[~covered] != 0).any()):
            worst[i] = float("inf")
    return worst, (worst_ctl if tf32_control else None)


def finite(x) -> float:
    """A reading as a float, with NaN read as unbounded."""
    v = float(x)
    return v if np.isfinite(v) else float("inf")


def dropout_masks(gen: torch.Generator, layers: int, n: int, width: int,
                  p: float, device) -> torch.Tensor:
    """One step's dropout masks, (layers, n, width) float32: 0 with
    probability ``p``, else 1 / (1 - p), from the benchmark's generator."""
    keep = torch.rand((layers, n, width), generator=gen, device=device) >= p
    return keep.float().mul_(1.0 / (1.0 - p))


class _Spmm(torch.autograd.Function):
    """A @ X, with Aᵀ @ G as its gradient."""

    @staticmethod
    def forward(ctx, x, a, at, tf32):
        ctx.at, ctx.tf32 = at, tf32
        return a.matmul(x, tf32)

    @staticmethod
    def backward(ctx, g):
        return ctx.at.matmul(g, ctx.tf32), None, None, None


class _MmTf32(torch.autograd.Function):
    """X @ W from TF32-rounded operands, in the forward and the backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _lower(x, True) @ _lower(w, True)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _lower(g, True)
        return g @ _lower(w, True).T, _lower(x, True).T @ g


def gcn_forward(a: CooOperator, at: CooOperator, x: torch.Tensor,
                leaves: List[torch.Tensor], masks: torch.Tensor,
                tf32: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """OGB's GCN: for each layer ``A @ (H W) + b``, then on every layer
    but the last batch norm (batch statistics), ReLU and dropout (the
    given masks); the log-probabilities.  ``leaves`` are, layer by layer,
    W and b, then the batch norm's weight and bias."""
    h, i = x, 0
    layers = masks.shape[0] + 1
    for layer in range(layers):
        w, b = leaves[i], leaves[i + 1]
        hw = _MmTf32.apply(h, w) if tf32 else h @ w
        h = _Spmm.apply(hw, a, at, tf32) + b
        i += 2
        if layer < layers - 1:
            h = F.batch_norm(h, None, None, leaves[i], leaves[i + 1],
                             training=True, eps=eps)
            h = torch.relu(h) * masks[layer].double()
            i += 2
    return torch.log_softmax(h, dim=1)


def gcn_steps(a: CooOperator, at: CooOperator, x: torch.Tensor,
              labels: torch.Tensor, train_idx: torch.Tensor,
              leaves: List[torch.Tensor], mask_seed: int, p_drop: float,
              lr: float, steps: int, tf32: bool = False) -> Dict[str, list]:
    """``steps`` full-batch Adam steps of :func:`gcn_forward` under the
    mean negative log-likelihood of the training nodes, in float64, with
    the dropout masks drawn again from ``mask_seed``.  Returns each step's
    loss (before its update), the first step's log-probabilities and
    gradients, and the leaves after every step."""
    p = [t.detach().double().clone().requires_grad_() for t in leaves]
    opt = torch.optim.Adam(p, lr=lr, foreach=False)
    gen = torch.Generator(device=x.device).manual_seed(int(mask_seed))
    x = x.double()
    hidden = leaves[0].shape[1]
    losses, out1, grads, after = [], None, None, []
    for _ in range(steps):
        masks = dropout_masks(gen, (len(leaves) - 2) // 4, x.shape[0],
                              hidden, p_drop, x.device)
        opt.zero_grad(set_to_none=True)
        out = gcn_forward(a, at, x, p, masks, tf32)
        loss = F.nll_loss(out[train_idx], labels[train_idx])
        loss.backward()
        losses.append(float(loss.detach()))
        if grads is None:
            out1 = out.detach()
            grads = [t.grad.detach().clone() for t in p]
        opt.step()
        after.append([t.detach().clone() for t in p])
    return {"losses": losses, "out": out1, "grads": grads, "weights": after}
