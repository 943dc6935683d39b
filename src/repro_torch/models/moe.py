"""Mixture-of-Experts with sort-based (SpMM-style) dispatch.

A port of ``repro.models.moe``.  Token->expert dispatch is a block-sparse
SpMM: A is the one-hot dispatch matrix, B the token activations.  Tokens
are packed into ``[E, C, d]`` capacity groups, run through grouped GEMMs
(``torch.bmm``, the block-diagonal instance of the flat tile stream) and
combined; the capacity split plays the role of the paper's dense-core /
fringe partition: pairs within capacity take the matrix path, overflow
pairs are dropped or (``fringe_overflow=True``) run through a gather /
scatter fringe pass.

Capacity slots come from a cumulative sum over ``(token, k)`` pairs in
token-major order, as in the reference, so drops fall on the same pairs.
The scatter-pack is ``index_put_(..., accumulate=True)``: each kept pair
owns its slot, and a dropped one adds an exact 0, so the pack's order does
not matter.  The combine is the reference's ``segment_sum`` over
``tok_ids``; the pairs are token-major, k to a token, so it is a sum over
the k axis of a reshape, deterministic on the card.  (With ``index_add_``,
an atomic add there, granite-moe's bf16 prefill logits differed from its
forward's by 0.18-0.23 on an H100, where the dense models' agree bit for
bit.)
``torch.topk`` may order tied probabilities differently from
``jax.lax.top_k``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import Init, gelu, silu

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_expert: int          # per-expert FFN width
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"
    shared_expert: bool = False  # llama4-style always-on shared FFN
    d_shared: int = 0
    fringe_overflow: bool = False  # route capacity overflow via fringe pass
    router_jitter: float = 0.0
    impl: str = "dense"  # dense | shard_map (not ported yet)

    def capacity(self, tokens: int) -> int:
        c = int(np.ceil(tokens * self.top_k * self.capacity_factor / self.num_experts))
        return max(8, ((c + 7) // 8) * 8)


def init_moe(init: Init, spec: MoESpec) -> Params:
    d, f, e = spec.d_model, spec.d_expert, spec.num_experts
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    p: Params = {
        "router": init.normal((d, e), s_in),
        "w_in": init.normal((e, d, f), s_in),
        "w_out": init.normal((e, f, d), s_out),
    }
    if spec.mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = init.normal((e, d, f), s_in)
    if spec.shared_expert:
        ds = spec.d_shared or f
        p["shared_w_in"] = init.normal((d, ds), s_in)
        p["shared_w_gate"] = init.normal((d, ds), s_in)
        p["shared_w_out"] = init.normal((ds, d), 1.0 / np.sqrt(ds))
    return p


def _act(kind: str):
    return silu if kind == "swiglu" else gelu


def _expert_ffn(params: Params, xs: torch.Tensor, kind: str) -> torch.Tensor:
    """xs: (E, C, d) -> (E, C, d) grouped GEMMs (block-diagonal SpMM)."""
    h = torch.bmm(xs, params["w_in"].to(xs.dtype))
    if kind in ("swiglu", "geglu"):
        h = _act(kind)(torch.bmm(xs, params["w_gate"].to(xs.dtype))) * h
    elif kind == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = gelu(h)
    return torch.bmm(h, params["w_out"].to(xs.dtype))


def apply_moe(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    spec: MoESpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatches to the configured implementation."""
    if spec.impl == "shard_map":
        raise NotImplementedError(
            "moe_impl='shard_map' needs the LM half of "
            "distributed/sharding.py, which is not ported yet (ROADMAP.md, "
            "A-queue 9b); use moe_impl='dense'")
    return apply_moe_dense(params, x, spec)


def apply_moe_dense(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    spec: MoESpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). Sort-based capacity dispatch."""
    b, s, d = x.shape
    t = b * s
    e, k = spec.num_experts, spec.top_k
    xt = x.reshape(t, d)

    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)  # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)

    # --- dispatch (the SpMM): position of each (token, k) in its expert ---
    flat_e = expert_ids.reshape(-1)                      # (T*k,)
    onehot = F.one_hot(flat_e, e)                        # (T*k, E)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1  # 0-based
    cap = spec.capacity(t)
    within = slot < cap

    tok_ids = torch.arange(t, device=x.device).repeat_interleave(k)
    safe_slot = torch.where(within, slot, 0)
    contrib = torch.where(within[:, None], xt[tok_ids], 0.0)
    xs = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    xs.index_put_((flat_e, safe_slot), contrib, accumulate=True)  # pack

    ys = _expert_ffn(params, xs, spec.mlp_kind)          # (E, C, d)

    gathered = torch.where(within[:, None], ys[flat_e, safe_slot], 0.0)
    gates = gate_vals.reshape(-1)[:, None].to(x.dtype)
    out = (gathered * gates).reshape(t, k, d).sum(dim=1)  # segment_sum

    if spec.fringe_overflow:
        # fringe pass for dropped pairs: one gather-FFN-scatter over all
        # experts, selected per pair (the reference applies the activation
        # only for the gated kinds here)
        dropped = ~within
        fr_x = torch.where(dropped[:, None], xt[tok_ids], 0.0)
        w_in = params["w_in"].to(x.dtype)
        fr_h = torch.einsum("td,edf->tef", fr_x, w_in)
        fr_sel = F.one_hot(flat_e, e).to(x.dtype)
        if spec.mlp_kind in ("swiglu", "geglu"):
            fr_g = torch.einsum("td,edf->tef", fr_x,
                                params["w_gate"].to(x.dtype))
            fr_h = _act(spec.mlp_kind)(fr_g) * fr_h
        fr_h = torch.einsum("tef,te->tf", fr_h, fr_sel)
        fr_y = torch.einsum("tf,efd,te->td", fr_h,
                            params["w_out"].to(x.dtype), fr_sel)
        fr_y = torch.where(dropped[:, None], fr_y, 0.0)
        out = out + (fr_y * gates).reshape(t, k, d).sum(dim=1)

    if spec.shared_expert:
        g = xt @ params["shared_w_gate"].to(x.dtype)
        hh = xt @ params["shared_w_in"].to(x.dtype)
        out = out + (silu(g) * hh) @ params["shared_w_out"].to(x.dtype)

    return out.reshape(b, s, d).to(x.dtype), aux
