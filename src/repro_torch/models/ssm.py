"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) in plain PyTorch.

A port of ``repro.models.ssm``.  Chunked SSD: the sequence is split into
chunks of length Q; the intra-chunk term is a masked quadratic form and the
inter-chunk term is a linear state recurrence, run as a Python loop over
chunks.  The heavy products take fp32 copies of their operands (the
reference accumulates its bf16 operands in fp32); every decay and softplus
statistic stays fp32.  The reference's five-operand einsum is contracted
in two steps, so no ``(B, nc, Q, Q, H, P)`` intermediate is made.

Decode keeps a constant-size state (B, H, P, N) plus the conv tail; a
one-token step pads to a whole chunk, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (
    constrain, gather_weight, grad_reduced, to_placements,
)
from .layers import Init, silu

Params = Dict[str, Any]
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    state_dim: int          # N
    head_dim: int = 64      # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_ssm(init: Init, spec: SSMSpec) -> Params:
    d, di, n, h = spec.d_model, spec.d_inner, spec.state_dim, spec.num_heads
    s = 1.0 / d ** 0.5
    # fused input projection: [z, x, B, C, dt]
    d_proj = 2 * di + 2 * n + h
    return {
        "in_proj": init.normal((d, d_proj), s),
        "conv_w": init.normal((spec.d_conv, di + 2 * n), 0.2),
        "conv_b": init.full((di + 2 * n,), 0.0),
        "a_log": init.const(torch.log(torch.linspace(1.0, 16.0, h))),
        "dt_bias": init.full((h,), 0.0),
        "d_skip": init.full((h,), 1.0),
        "norm_scale": init.full((di,), 1.0),
        "out_proj": init.normal((di, d), 1.0 / di ** 0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: (B, S, C); w: (K, C). Returns (y, new_tail)."""
    kw = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    new_tail = xp[:, -(kw - 1):] if kw > 1 else tail
    y = sum(
        xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(kw)
    ) + b[None, None, :]
    return silu(y), new_tail


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) by ``pad`` at the end."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def _ssd_chunked(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)   (softplus-ed, fp32)
    a: torch.Tensor,     # (H,)        (negative decay rates)
    bmat: torch.Tensor,  # (B, S, N)
    cmat: torch.Tensor,  # (B, S, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimal SSD (Dao & Gu 2024, alg. 1 'quadratic mode' per chunk)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = chunk
    pad = (-s) % q
    if pad:
        x, dt, bmat, cmat = (_pad_seq(t, pad) for t in (x, dt, bmat, cmat))
    nc = x.shape[1] // q
    xc = x.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()

    da = dtc * a[None, None, None, :]          # (B, nc, Q, H) log-decay increments
    cum = torch.cumsum(da, dim=2)              # within-chunk cumulative
    seg_total = cum[:, :, -1]                  # (B, nc, H)

    # intra-chunk (quadratic) term: L[i,j] = exp(cum_i - cum_j) for i >= j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask BEFORE exp: exp of the masked (positive) entries would overflow
    l_mat = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], NEG))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B,nc,Q,Q)
    # "bcij,bcijh,bcjh,bcjhp->bcihp" in two steps
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * l_mat,
                          dtc[..., None] * xc)

    # chunk states: decayed sum of B dt x within the chunk
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)  # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqhp->bchpn", bc,
                          (decay_to_end * dtc)[..., None] * xc)

    # inter-chunk recurrence
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(seg_total[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    # off-diagonal term: carry-in state read out through C with decay
    decay_from_start = torch.exp(cum)  # (B,nc,Q,H)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states) \
        * decay_from_start[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y, st


def apply_ssm(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    spec: SSMSpec,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    # state = (ssd_state (B,H,P,N), conv_tail (B, d_conv-1, di+2N)) — decode
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    b, s, _ = x.shape
    di, n, h = spec.d_inner, spec.state_dim, spec.num_heads
    proj = grad_reduced(x) @ gather_weight(params["in_proj"], x.dtype)
    partitioned = hasattr(proj, "placements")
    if partitioned:
        # the fused projection's TP split does not follow its parts:
        # gather it over TP, then split each part by heads
        proj = constrain(proj, "batch", "seq", None)
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    scan = _scan_partitioned if partitioned else _scan
    y, final_state, new_tail = scan(params, xbc, dt_raw, spec, state,
                                    x.dtype)
    # gated RMSNorm (mamba2)
    if partitioned:
        z = to_placements(z, y.placements)
    y32 = y.float() * silu(z.float())
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    scale = params["norm_scale"].float()
    if partitioned:
        from torch.distributed.tensor import Shard

        scale = to_placements(scale, tuple(
            Shard(0) if p.is_shard(2) else p for p in y.placements))
    y = (y32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)
    out = y @ gather_weight(params["out_proj"], x.dtype)
    new_state = None if state is None else (final_state, new_tail)
    return constrain(out, "batch", "seq", None), new_state


def _scan(params: Params, xbc: torch.Tensor, dt_raw: torch.Tensor,
          spec: SSMSpec, state, dtype):
    """Causal conv, softplus, chunked SSD and the skip: (y (B, S, di) in
    ``dtype``, final SSD state, new conv tail)."""
    b, s, _ = xbc.shape
    di, n, h, p = spec.d_inner, spec.state_dim, spec.num_heads, spec.head_dim
    conv_tail = None if state is None else state[1]
    xbc, new_tail = _causal_conv(
        xbc, params["conv_w"].to(dtype), params["conv_b"].to(dtype),
        tail=conv_tail,
    )
    xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    y, final_state = _heads_scan(xs, bmat, cmat, dt_raw, params["dt_bias"],
                                 params["a_log"], params["d_skip"], spec,
                                 None if state is None else state[0])
    return y.reshape(b, s, di).to(dtype), final_state, new_tail


def _heads_scan(xs, bmat, cmat, dt_raw, dt_bias, a_log, d_skip,
                spec: SSMSpec, initial_state):
    """The SSD scan and skip of ``xs``'s heads (any number of them):
    (y (B, S, H, P) fp32, final state)."""
    b, s, c = xs.shape
    p = spec.head_dim
    h = c // p
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt_raw.float() + dt_bias.float(),
                         torch.zeros((), device=xs.device))
    a = -torch.exp(a_log.float())
    xh = xs.reshape(b, s, h, p)
    y, final_state = _ssd_chunked(xh, dt, a, bmat, cmat, spec.chunk,
                                  initial_state=initial_state)
    y = y + d_skip.float()[None, None, :, None] * xh.float()
    return y, final_state


def _scan_partitioned(params: Params, xbc: torch.Tensor,
                      dt_raw: torch.Tensor, spec: SSMSpec, state, dtype):
    """:func:`_scan` of a partitioned program.  ``xbc`` and ``dt_raw``
    come replicated over TP; every device convolves and scans its own
    heads (its TP slice of x's channels, of dt and of the per-head
    params) with the whole B and C (``local_map``, no collective inside),
    as the SSD state cache is split, by heads.  y comes out split over TP
    by channel, the state by heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import active_rules

    b, s, _ = xbc.shape
    di, n = spec.d_inner, spec.state_dim
    mesh = xbc.device_mesh
    names = list(mesh.mesh_dim_names)
    rules = active_rules()
    tp = names.index(rules.tp_axis) if rules.tp_axis in names else None
    batch = [i for i, q in enumerate(xbc.placements) if q.is_shard(0)]
    rep = (Replicate(),) * mesh.ndim

    def pl(dim):   # the batch split, and TP over ``dim`` (None: no TP)
        return tuple(Shard(0) if i in batch else
                     Shard(dim) if i == tp and dim is not None
                     else Replicate() for i in range(mesh.ndim))

    def w_pl(dim):   # a weight: TP over ``dim`` or replicated
        return tuple(Shard(dim) if i == tp and dim is not None
                     else Replicate() for i in range(mesh.ndim))

    def partial_over(dims, keep):   # a gradient summed over ``dims``
        return tuple(Partial() if i in dims else q
                     for i, q in enumerate(keep))

    conv_w = to_placements(params["conv_w"].to(dtype), rep)
    conv_b = to_placements(params["conv_b"].to(dtype), rep)
    xs_raw, bc_raw = torch.split(xbc, [di, 2 * n], dim=-1)
    args = [to_placements(xs_raw, pl(2)), bc_raw, to_placements(
        dt_raw, pl(2)),
        to_placements(conv_w[:, :di], w_pl(1)), conv_w[:, di:],
        to_placements(conv_b[:di], w_pl(0)), conv_b[di:]]
    args += [to_placements(params[k], w_pl(0))
             for k in ("dt_bias", "a_log", "d_skip")]
    in_pl = [pl(2), pl(None), pl(2), w_pl(1), rep, w_pl(0), rep,
             w_pl(0), w_pl(0), w_pl(0)]
    # each device's gradients cover its own tokens (partial over the
    # batch axes) and, for what every head reads (B, C and their conv
    # weights), its own heads (partial over TP)
    grad_pl = [pl(2), partial_over([tp], pl(None)), pl(2)]
    grad_pl += [partial_over(batch, w) for w in in_pl[3:]]
    grad_pl[4] = grad_pl[6] = (Partial(),) * mesh.ndim
    if state is not None:
        tail_x, tail_bc = torch.split(to_placements(state[1], pl(None)),
                                      [di, 2 * n], dim=-1)
        args += [to_placements(state[0], pl(1)),
                 to_placements(tail_x, pl(2)), tail_bc]
        in_pl += [pl(1), pl(2), pl(None)]
        grad_pl += [pl(1), pl(2), partial_over([tp], pl(None))]

    def body(xs_raw, bc_raw, dt_raw, cw_x, cw_bc, cb_x, cb_bc, dt_bias,
             a_log, d_skip, init=None, tail_x=None, tail_bc=None):
        xs, new_x = _causal_conv(xs_raw, cw_x, cb_x, tail=tail_x)
        bc, new_bc = _causal_conv(bc_raw, cw_bc, cb_bc, tail=tail_bc)
        bmat, cmat = torch.split(bc, [n, n], dim=-1)
        y, final = _heads_scan(xs, bmat, cmat, dt_raw, dt_bias, a_log,
                               d_skip, spec, init)
        return (y.reshape(xs.shape).to(dtype), final, new_x, new_bc)

    y, final, new_x, new_bc = local_map(
        body, out_placements=(pl(2), pl(1), pl(2), pl(None)),
        in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
        device_mesh=mesh)(*args)
    new_tail = torch.cat([to_placements(new_x, pl(None)), new_bc], dim=-1)
    return y, final, new_tail


def init_ssm_state(
    batch: int, spec: SSMSpec, dtype=torch.float32, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((batch, spec.num_heads, spec.head_dim, spec.state_dim),
                    dtype=dtype, device=device),
        torch.zeros((batch, spec.d_conv - 1, spec.d_inner + 2 * spec.state_dim),
                    dtype=dtype, device=device),
    )
