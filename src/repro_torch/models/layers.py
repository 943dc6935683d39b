"""Sparse graph layers on the ``repro_torch.sparse`` operators.

Ports of ``repro.models.layers.SparseGraphConv`` and
``SparseGraphAttention`` as ``nn.Module``\\ s.  Each holds a prepared
:class:`~repro_torch.sparse.SparseMatrix` (the graph) and its weights,
laid out as in the reference ((d_in, d_out), applied as ``x @ w``).
``SparseGraphConv``'s weight is an ``nn.Parameter``: the layer is linear
in X and its aggregation is differentiable (``sparse.spmm``), so it
trains, as the reference's composes with ``jax.grad``
(``repro_torch.examples.gcn_training``).  ``SparseGraphAttention`` keeps
its weights as buffers: its value swap goes through the host, and the
reference calls that layer inference/forward oriented.

The projections are plain ``torch.matmul``; the edge softmax is plain
segment arithmetic (``scatter_reduce`` with amax, ``index_add_``).  The
sparse products run the port's kernels: SDDMM (``dense_tile_sddmm`` and
``gather_sddmm``) for the scores and SpMM (``dense_tile_spmm`` and the
fringe gather) for the aggregation.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import sparse as sp


def _graph(a) -> sp.SparseMatrix:
    return a if isinstance(a, sp.SparseMatrix) else sp.from_plan(a)


def _normal(shape, scale: float, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * scale


class SparseGraphConv(nn.Module):
    """GCN aggregation layer: ``A @ (X W)`` with A a SparseMatrix."""

    def __init__(self, a, w: torch.Tensor):
        super().__init__()
        self.a = _graph(a)
        self.w = nn.Parameter(w.detach().to(self.a.device, torch.float32))

    @classmethod
    def init(cls, a, d_in: int, d_out: int,
             generator: Optional[torch.Generator] = None) -> "SparseGraphConv":
        a = _graph(a)
        return cls(a, _normal((d_in, d_out), 1.0 / math.sqrt(d_in),
                              generator, a.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sp.spmm(self.a, x @ self.w)


class SparseGraphAttention(nn.Module):
    """Single-head dot-product graph attention (GAT-style).

    Scores are an SDDMM over the graph's pattern, ``(Q K^T)/sqrt(d)`` at
    the edges only, followed by a softmax over each destination row's
    edges and one SpMM with the attention weights swapped in by
    ``SparseMatrix.with_values`` (same plan signature, same executor).
    """

    def __init__(self, a, wq: torch.Tensor, wk: torch.Tensor,
                 wv: torch.Tensor):
        super().__init__()
        self.a = _graph(a)
        dev = self.a.device
        self.register_buffer("wq", wq.to(dev, torch.float32))
        self.register_buffer("wk", wk.to(dev, torch.float32))
        self.register_buffer("wv", wv.to(dev, torch.float32))
        # edge endpoints are static per graph; the softmax segments by row
        self.register_buffer(
            "rows", torch.from_numpy(self.a.row).to(dev, torch.int64),
            persistent=False)

    @classmethod
    def init(cls, a, d_in: int, d_head: int,
             generator: Optional[torch.Generator] = None
             ) -> "SparseGraphAttention":
        a = _graph(a)
        s = 1.0 / math.sqrt(d_in)
        return cls(a, *(_normal((d_in, d_head), s, generator, a.device)
                        for _ in range(3)))

    def edge_scores(self, x: torch.Tensor) -> torch.Tensor:
        """Softmaxed attention weight per edge, in input COO order."""
        q = x @ self.wq
        k = x @ self.wk
        e = sp.sddmm(self.a, q, k.t()) / math.sqrt(self.wq.shape[1])
        m = self.a.shape[0]
        e_max = torch.full((m,), -math.inf, dtype=e.dtype, device=e.device)
        e_max = e_max.scatter_reduce(0, self.rows, e, "amax")
        p = torch.exp(e - e_max[self.rows])
        denom = torch.zeros(m, dtype=e.dtype, device=e.device)
        denom.index_add_(0, self.rows, p)
        return p / denom[self.rows].clamp(min=1e-30)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.edge_scores(x)
        a_att = self.a.with_values(alpha)
        return sp.spmm(a_att, x @ self.wv)
