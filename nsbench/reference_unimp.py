"""The plain reference of UniMP's forward, in float64, with plain PyTorch
operations.

UniMP (Shi et al. 2021, arXiv:2009.03509) as PyTorch Geometric's
``examples/unimp_arxiv.py`` builds it from ``TransformerConv(...,
beta=True)``: for node i, head h of width C and j over the nonzeros of row
i of A,

- q, k, v, r = x W + b (the queries, keys and values of every head and
  the root term; ``W`` laid out ``[W_q | W_k | W_v | W_r]``);
- α_hij = softmax over j of (q_hi · k_hj) / √C;
- m_i = the concatenation over h of Σ_j α_hij v_hj, or in the last layer
  their mean over the heads;
- β_i = sigmoid(w_βᵀ [m_i ‖ r_i ‖ m_i − r_i]), y_i = β_i r_i + (1 − β_i) m_i;
- LayerNorm and then ReLU between layers; the input carries the masked
  label embedding, x_i + E[label_i] at the nodes whose labels are given
  (``MaskLabel``, method ``add``).  No dropout: the forward is inference.

Departure from the paper, as the configuration states it: attention runs
over the nonzeros of A, which holds the diagonal (A + I), so over N(i)
and i itself.

It imports nothing of the program and takes nothing the program made: it
is handed the COO structure, the inputs and the weights the benchmark
drew.  TF32 is off for its products.  The scores, softmax and aggregation
run row by row: rows bucketed by degree, each block of rows padded to its
bucket's width, its neighbours' keys and values gathered and multiplied
in float64, so no row depends on another and the whole graph never has to
fit at once.  ``tf32=True`` computes the same from operands rounded to
TF32 (every operand of every product: the projections, the scores, the
aggregation and the gate), the control that has to fail the comparison.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nsbench.reference import to_tf32

# elements of one gathered (rows, width, C) block: 1 GiB in float64
BLOCK_ELEMENTS = 1 << 27


@contextlib.contextmanager
def no_tf32():
    """TF32 off for PyTorch's float32 products, as it was after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _lower(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return to_tf32(x).double() if tf32 else x.double()


class Graph:
    """A's structure, by rows bucketed by ceil(log2(degree)), on a device:
    from its COO ``rows`` and ``cols`` in input order."""

    def __init__(self, rows, cols, m: int, device="cpu"):
        dev = torch.device(device)
        rows = torch.as_tensor(np.asarray(rows, np.int64)).to(dev)
        cols = torch.as_tensor(np.asarray(cols, np.int64)).to(dev)
        self.m, self.nnz, self.device = int(m), int(rows.numel()), dev
        self.order = torch.argsort(rows, stable=True)
        self.cols = cols[self.order]
        self.deg = torch.bincount(rows, minlength=self.m)
        self.starts = torch.cumsum(self.deg, 0) - self.deg
        nz = torch.nonzero(self.deg).squeeze(1)
        width = torch.ceil(torch.log2(self.deg[nz].double())).long()
        self.buckets = [(1 << int(w), nz[width == w])
                        for w in torch.unique(width).tolist()]

    def blocks(self, c: int):
        """``(rows, pos, mask)`` over blocks of rows: ``pos`` (R, width)
        positions in row order, ``mask`` where they are real."""
        for width, rows in self.buckets:
            per = max(1, BLOCK_ELEMENTS // (width * max(c, 1)))
            j = torch.arange(width, device=self.device)
            for lo in range(0, rows.numel(), per):
                r = rows[lo:lo + per]
                mask = j[None, :] < self.deg[r][:, None]
                pos = torch.where(mask, self.starts[r][:, None] + j[None, :],
                                  0)
                yield r, pos, mask

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               tf32: bool = False, want_alpha: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One head: ``(out, alpha)``, out (m, C) = Σ_j α_ij v_j with α
        the softmax over row i's nonzeros of (q_i · k_j) / √C, in float64;
        alpha (nnz,) in input order where asked."""
        c = q.shape[1]
        q, k, v = (_lower(t, tf32) for t in (q, k, v))
        out = torch.zeros((self.m, c), dtype=torch.float64,
                          device=self.device)
        alpha = (torch.zeros(self.nnz, dtype=torch.float64,
                             device=self.device) if want_alpha else None)
        for r, pos, mask in self.blocks(c):
            col = self.cols[pos]
            s = torch.bmm(k[col], q[r][:, :, None])[:, :, 0] / math.sqrt(c)
            s = s.masked_fill(~mask, -math.inf)
            p = torch.exp(s - s.max(1, keepdim=True).values)
            a = p / p.sum(1, keepdim=True)
            if tf32:
                a = _lower(a, True)
            out[r] = torch.bmm(a[:, None, :], v[col])[:, 0, :]
            if alpha is not None:
                alpha[self.order[pos[mask]]] = a[mask]
        return out, alpha


def _mm(x: torch.Tensor, w: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _lower(x, tf32) @ _lower(w, tf32)


def layer(graph: Graph, x: torch.Tensor, p: Dict[str, object],
          tf32: bool = False, want_alpha: bool = False
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One ``TransformerConv(beta=True)``: ``p`` holds ``weight`` (d_in,
    3·H·C + R), ``bias``, ``w_beta`` (3R,), ``heads``, ``concat`` and
    ``root`` (R).  Returns the output (m, R) in float64 and, where asked,
    the attention weights (H, nnz) in input order."""
    heads, root = int(p["heads"]), int(p["root"])
    z = _mm(x, p["weight"], tf32) + p["bias"].double()
    c = (z.shape[1] - root) // (3 * heads)
    outs, alphas = [], []
    for h in range(heads):
        q, k, v = (z[:, (part * heads + h) * c:(part * heads + h + 1) * c]
                   for part in range(3))
        o, a = graph.attend(q, k, v, tf32, want_alpha)
        outs.append(o)
        alphas.append(a)
    m = torch.cat(outs, 1) if p["concat"] else torch.stack(outs).mean(0)
    r = z[:, z.shape[1] - root:]
    beta = torch.sigmoid(_mm(torch.cat([m, r, m - r], 1),
                             p["w_beta"][:, None], tf32))
    y = beta * r + (1 - beta) * m
    return y, (torch.stack(alphas) if want_alpha else None)


def forward(graph: Graph, x: torch.Tensor, labels: torch.Tensor,
            known: torch.Tensor, weights: Dict[str, object],
            tf32: bool = False, want_alpha: bool = False,
            eps: float = 1e-5
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """UniMP's logits (m, classes) in float64 and, where asked, the first
    layer's attention weights (H, nnz).  ``weights``: ``emb`` (classes,
    d_in), ``layers`` (each as :func:`layer` takes it) and ``norms`` (a
    (weight, bias) pair after every layer but the last)."""
    with no_tf32():
        h = x.double().index_add(0, known,
                                 weights["emb"].double()[labels[known]])
        layers: List[Dict[str, object]] = weights["layers"]
        alpha = None
        for i, p in enumerate(layers):
            h, a = layer(graph, h, p, tf32, want_alpha and i == 0)
            if i == 0:
                alpha = a
            if i < len(layers) - 1:
                w, b = weights["norms"][i]
                h = torch.relu(F.layer_norm(h, (h.shape[1],), w.double(),
                                            b.double(), eps))
    return h, alpha
