"""Model layers: the LM stack's building blocks and the sparse graph layers.

The LM half ports ``repro.models.layers``'s functional blocks: RMSNorm,
RoPE (split halves, not interleaved), blockwise attention (GQA/MQA, local
windows, soft-capping, a KV cache) and the four MLP kinds.  Params are
nested dicts of tensors; every ``init_*`` takes an :class:`Init` (the
generator, device, dtype and leading stack axes) and returns params, and
every ``apply_*`` is shape-polymorphic over batch and sequence.  The
projections are plain ``torch.matmul`` in the compute dtype, as the
reference's XLA einsums are; attention is an online-softmax loop over KV
chunks whose two products take fp32 copies of their operands (the
reference accumulates its bf16 products in fp32, and a product of two
bf16 values is exact in fp32).  Masks use -1e30, never -inf, as the
reference's do: a fully masked chunk then contributes ``exp(0)`` per
entry, which the next unmasked chunk rescales to 0.

The graph half ports ``repro.models.layers.SparseGraphConv`` and
``SparseGraphAttention`` as ``nn.Module``\\ s.  Each holds a prepared
:class:`~repro_torch.sparse.SparseMatrix` (the graph) and its weights,
laid out as in the reference ((d_in, d_out), applied as ``x @ w``).
``SparseGraphConv``'s weight is an ``nn.Parameter``: the layer is linear
in X and its aggregation is differentiable (``sparse.spmm``), so it
trains, as the reference's composes with ``jax.grad``
(``repro_torch.examples.gcn_training``).  ``SparseGraphAttention`` keeps
its weights as buffers: its value swap goes through the host, and the
reference calls that layer inference/forward oriented.

The graph projections are plain ``torch.matmul``; the edge softmax is plain
segment arithmetic (``scatter_reduce`` with amax, ``index_add_``).  The
sparse products run the port's kernels: SDDMM (``dense_tile_sddmm`` and
``gather_sddmm``) for the scores and SpMM (``dense_tile_spmm`` and the
fringe gather) for the aggregation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import sparse as sp
from ..distributed.sharding import (
    constrain, gather_weight, grad_reduced as _rg, logical_placements,
    to_placements,
)

Params = Dict[str, Any]
NEG = -1e30  # the reference's mask value (never -inf)


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Init:
    """Where and how ``init_*`` makes its leaves.

    Normal draws come from ``generator`` on the generator's own device and
    move to ``device``; ``lead`` prefixes every leaf's shape (the stacked
    layer groups).  With ``generator=None`` the leaves are ``meta`` tensors:
    shapes and dtypes only, which ``interop`` checks a carried-over tree
    against.  Torch's random stream is not JAX's: the keys, shapes, dtypes
    and scales are the reference's, the values are not.
    """

    generator: Optional[torch.Generator]
    device: torch.device
    dtype: torch.dtype = torch.float32
    lead: Tuple[int, ...] = ()

    def _shape(self, shape) -> Tuple[int, ...]:
        return self.lead + tuple(shape)

    def normal(self, shape, scale: float) -> torch.Tensor:
        if self.generator is None:
            return torch.empty(self._shape(shape), dtype=self.dtype,
                               device="meta")
        x = torch.randn(self._shape(shape), generator=self.generator,
                        dtype=self.dtype, device=self.generator.device)
        return (x * scale).to(self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        device = "meta" if self.generator is None else self.device
        return torch.full(self._shape(shape), value, dtype=self.dtype,
                          device=device)

    def const(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` (computed in fp32) in this dtype, under ``lead``."""
        device = "meta" if self.generator is None else self.device
        v = values.to(device, self.dtype)
        return v.expand(self.lead + tuple(v.shape)).clone()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rms_norm(init: Init, d: int) -> Params:
    return {"scale": init.full((d,), 1.0)}


def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Rotates the two split
    halves of D, as the reference does (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention
# ---------------------------------------------------------------------------
def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool,
    q_offset: int = 0,              # absolute position of q[0] (decode)
    window: Optional[int] = None,   # local attention window (gemma2)
    softcap: Optional[float] = None,
    kv_chunk: int = 1024,
    kv_len: Optional[int] = None,   # valid KV prefix length (decode)
    unroll: int = 1,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; O(Sq * kv_chunk) memory.

    GQA: H must be a multiple of KV; queries are grouped.  The two products
    run on fp32 copies of their operands (the reference's fp32 accumulation
    of bf16 operands); the softmax statistics stay fp32.  A short last
    chunk is padded with zeros, as the reference pads K and V.  ``unroll``
    is the reference's scan knob and changes nothing here.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    kw = dict(causal=causal, q_offset=q_offset, window=window,
              softcap=softcap, kv_chunk=kv_chunk, kv_len=kv_len)
    if hasattr(q, "placements") and sq != 1:
        if h != kv:
            # a partitioned program splits the heads over TP, which a KV
            # head count below the TP degree cannot follow: each KV head
            # is repeated for its query group (the same products)
            k, v = _repeat_kv(k, h // kv), _repeat_kv(v, h // kv)
        return _local_attention(q, k, v, kw)
    if sq == 1:
        # decode: the reference pins q and the cache to head-dim TP
        # sharding; contracting over it costs one small logits sum
        q = constrain(q, "batch", None, None, "heads")
        k = constrain(k, "batch", None, None, "heads")
        v = constrain(v, "batch", None, None, "heads")
    groups = h // kv
    scale = 1.0 / np.sqrt(d)

    qf = (q * scale).to(q.dtype).reshape(b, sq, kv, groups, d).float()
    if sq == 1:
        qf = constrain(qf, "batch", None, None, None, "heads")
    q_pos = q_offset + torch.arange(sq, device=q.device)  # (Sq,)

    n_chunks = max(1, (sk + kv_chunk - 1) // kv_chunk)
    valid_len = sk if kv_len is None else int(kv_len)

    if hasattr(qf, "placements"):
        # a partitioned decode: the statistics take the placements of the
        # first chunk's
        m = l = None
        acc = torch.zeros_like(qf)
    else:
        m = torch.full((b, sq, kv, groups), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, sq, kv, groups), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, sq, kv, groups, d), dtype=torch.float32,
                          device=q.device)
    for c_idx in range(n_chunks):
        lo = c_idx * kv_chunk
        k_blk, v_blk = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
        short = kv_chunk - k_blk.shape[1]
        if short:  # the reference pads K and V to whole chunks with 0s
            k_blk = F.pad(k_blk, (0, 0, 0, 0, 0, short))
            v_blk = F.pad(v_blk, (0, 0, 0, 0, 0, short))
        kv_pos = lo + torch.arange(kv_chunk, device=q.device)  # (C,)
        # (B, Sq, KV, G, C): fp32 products of the compute-dtype operands
        logits = _qk(qf, k_blk.float())
        logits = _softcap(logits, softcap)
        mask = (kv_pos < valid_len)[None, :]  # (1, C)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        logits = logits.masked_fill(~mask[None, :, None, None, :], NEG)
        m_cur = logits.amax(dim=-1)
        if m is None:
            m = torch.full_like(m_cur, NEG)
            l = torch.zeros_like(m_cur)
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _pv(p.to(v_blk.dtype).float(),
                                           v_blk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, d).to(q.dtype)


def _qk(qf: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """(B, Sq, KV, G, D) x (B, C, KV, D) -> logits (B, Sq, KV, G, C).  On
    DTensors split over D (decode), each device's product of its D slice,
    summed over those devices."""
    if not hasattr(qf, "placements"):
        return torch.einsum("bskgd,bckd->bskgc", qf, kf)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    out = [Partial() if p.is_shard(4) else p for p in qf.placements]
    logits = local_map(
        lambda a, b: torch.einsum("bskgd,bckd->bskgc", a, b),
        out_placements=out, in_placements=(tuple(qf.placements),
                                           tuple(kf.placements)),
        device_mesh=qf.device_mesh)(qf, kf)
    return to_placements(logits, tuple(
        Replicate() if p.is_partial() else p for p in logits.placements))


def _pv(p: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
    """(B, Sq, KV, G, C) x (B, C, KV, D) -> (B, Sq, KV, G, D); on DTensors
    each device's D slice of V."""
    if not hasattr(p, "placements"):
        return torch.einsum("bskgc,bckd->bskgd", p, vf)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    out = [Shard(4) if q.is_shard(3) else q for q in vf.placements]
    return local_map(
        lambda a, b: torch.einsum("bskgc,bckd->bskgd", a, b),
        out_placements=out, in_placements=(tuple(p.placements),
                                           tuple(vf.placements)),
        device_mesh=vf.device_mesh)(p, vf)


def _local_attention(q, k, v, kw) -> torch.Tensor:
    """Attention of a partitioned program: every device attends its own
    sequences and heads (q's placements; K and V moved there), on its
    local blocks (the counterpart of a ``shard_map`` body), as XLA
    partitions it: no collective inside.  (``local_map`` would infer the
    output's global shape from an even split; a head count that does not
    divide over TP is split unevenly, so the output takes q's.)"""
    from torch.distributed.tensor import DTensor

    pl = tuple(q.placements)
    k, v = to_placements(k, pl), to_placements(v, pl)
    out = blockwise_attention(q.to_local(), k.to_local(), v.to_local(),
                              **kw)
    return DTensor.from_local(out, q.device_mesh, pl, run_check=False,
                              shape=q.shape, stride=q.stride())


def _repeat_kv(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV * groups, D), each KV head repeated for
    the ``groups`` query heads that read it (head ``i`` reads KV head
    ``i // groups``, as the grouped reshape pairs them)."""
    b, s, kv, d = t.shape
    t = _whole(t, 2)
    return t[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(
        b, s, kv * groups, d)


def _whole(t: torch.Tensor, dim: int, n: Optional[int] = None
           ) -> torch.Tensor:
    """A DTensor split over ``dim`` where ``n`` (the dimension's size, or
    the count of heads it holds) does not divide over the mesh axis,
    gathered over that axis: DTensor reshapes only even splits.  Anything
    else unchanged."""
    if not hasattr(t, "placements"):
        return t
    n = t.shape[dim] if n is None else n
    mesh = t.device_mesh
    if not any(p.is_shard(dim) and n % mesh.size(i)
               for i, p in enumerate(t.placements)):
        return t
    from torch.distributed.tensor import Replicate

    return to_placements(t, tuple(Replicate() if p.is_shard(dim) else p
                                  for p in t.placements))


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  Under a partitioned program the
    heads are split over TP (an uneven split rounds up on rank 0, as XLA
    pads); a projection whose head count does not divide over TP is
    gathered before the reshape."""
    b, s, _ = t.shape
    t = _whole(t, 2, n).reshape(b, s, n, hd)
    pl = logical_placements(t.ndim, ("batch", None, "heads", None))
    return to_placements(t, pl) if pl is not None and hasattr(
        t, "placements") else t


# ---------------------------------------------------------------------------
# Attention block (GQA / MQA / MHA + cache)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None
    softcap: Optional[float] = None
    kv_chunk: int = 1024
    unroll: int = 1


def init_attention(init: Init, spec: AttnSpec) -> Params:
    d, h, kv, hd = spec.d_model, spec.num_heads, spec.num_kv_heads, spec.head_dim
    s = 1.0 / np.sqrt(d)
    p = {
        "wq": init.normal((d, h * hd), s),
        "wk": init.normal((d, kv * hd), s),
        "wv": init.normal((d, kv * hd), s),
        "wo": init.normal((h * hd, d), 1.0 / np.sqrt(h * hd)),
    }
    if spec.qkv_bias:
        p["bq"] = init.full((h * hd,), 0.0)
        p["bk"] = init.full((kv * hd,), 0.0)
        p["bv"] = init.full((kv * hd,), 0.0)
    return p


KVCache = Tuple[torch.Tensor, torch.Tensor, int]


def apply_attention(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    spec: AttnSpec,
    positions: torch.Tensor,  # (S,) or (B, S)
    cache: Optional[KVCache] = None,
    # cache = (k_cache (B, Smax, KV, hd), v_cache, length)  — decode mode
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Attention over ``x``; with a cache, writes this step's K and V into it
    *in place* at ``length`` and attends over the valid prefix.

    The write start is clamped to ``[0, Smax - S]``, as
    ``jax.lax.dynamic_update_slice_in_dim`` clamps it: a write at or past
    the end lands on the cache's last ``S`` rows.
    """
    b, s, _ = x.shape
    h, kv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = _rg(x) @ gather_weight(params["wq"], x.dtype)
    k = _rg(x) @ gather_weight(params["wk"], x.dtype)
    v = _rg(x) @ gather_weight(params["wv"], x.dtype)
    if spec.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q, k, v = _heads(q, h, hd), _heads(k, kv, hd), _heads(v, kv, hd)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)

    if cache is None:
        out = blockwise_attention(
            q, k, v, causal=spec.causal, window=spec.window,
            softcap=spec.softcap, kv_chunk=spec.kv_chunk,
            unroll=spec.unroll,
        )
        new_cache = None
    else:
        k_cache, v_cache, length = cache
        length = int(length)
        start = min(max(length, 0), k_cache.shape[1] - s)
        k_cache[:, start:start + s] = _like(k.to(k_cache.dtype), k_cache)
        v_cache[:, start:start + s] = _like(v.to(v_cache.dtype), v_cache)
        out = blockwise_attention(
            q, k_cache.to(q.dtype), v_cache.to(q.dtype),
            causal=spec.causal, q_offset=length, window=spec.window,
            softcap=spec.softcap, kv_chunk=spec.kv_chunk,
            kv_len=length + s, unroll=spec.unroll,
        )
        new_cache = (k_cache, v_cache, length + s)

    # (a gathered uneven split takes its gradient whole, too)
    merged = _rg(_whole(out, 2).reshape(b, s, h * hd))
    y = merged @ gather_weight(params["wo"], x.dtype)
    return constrain(y, "batch", "seq", None), new_cache


def _like(t: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``t`` in ``dst``'s placements, for an in-place write into ``dst``
    (a cache) under a partitioned program; else ``t``."""
    return to_placements(t, dst.placements) if hasattr(dst, "placements") \
        else t


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, two ops, each rounded to the
    compute dtype (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(init: Init, d: int, f: int, kind: str) -> Params:
    s_in = 1.0 / np.sqrt(d)
    s_out = 1.0 / np.sqrt(f)
    p = {
        "w_in": init.normal((d, f), s_in),
        "w_out": init.normal((f, d), s_out),
    }
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = init.normal((d, f), s_in)
    return p


def apply_mlp(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = _rg(x) @ gather_weight(params["w_in"], x.dtype)
    if kind == "swiglu":
        h = silu(_rg(x) @ gather_weight(params["w_gate"], x.dtype)) * h
    elif kind == "geglu":
        h = gelu(_rg(x) @ gather_weight(params["w_gate"], x.dtype)) * h
    elif kind == "squared_relu":  # nemotron-4
        h = torch.square(F.relu(h))
    elif kind == "gelu":
        h = gelu(h)
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    y = h @ gather_weight(params["w_out"], x.dtype)
    return constrain(y, "batch", "seq", None)


# ---------------------------------------------------------------------------
# Sparse graph layers (repro_torch.sparse operator family)
# ---------------------------------------------------------------------------
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
