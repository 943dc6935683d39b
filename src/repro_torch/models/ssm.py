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
    di, n, h, p = spec.d_inner, spec.state_dim, spec.num_heads, spec.head_dim
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    conv_tail = None if state is None else state[1]
    xbc, new_tail = _causal_conv(
        xbc, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype),
        tail=conv_tail,
    )
    xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt_raw.float() + params["dt_bias"].float(),
                         torch.zeros((), device=x.device))
    a = -torch.exp(params["a_log"].float())
    xh = xs.reshape(b, s, h, p)

    y, final_state = _ssd_chunked(
        xh, dt, a, bmat, cmat,
        spec.chunk,
        initial_state=None if state is None else state[0],
    )
    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, di).to(x.dtype)
    # gated RMSNorm (mamba2)
    y32 = y.float() * silu(z.float())
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + 1e-6) * params["norm_scale"].float()).to(x.dtype)
    out = y @ params["out_proj"].to(x.dtype)
    new_state = None if state is None else (final_state, new_tail)
    return out, new_state


def init_ssm_state(
    batch: int, spec: SSMSpec, dtype=torch.float32, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((batch, spec.num_heads, spec.head_dim, spec.state_dim),
                    dtype=dtype, device=device),
        torch.zeros((batch, spec.d_conv - 1, spec.d_inner + 2 * spec.state_dim),
                    dtype=dtype, device=device),
    )
