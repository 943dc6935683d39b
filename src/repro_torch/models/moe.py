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
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import (
    constrain, gather_weight, grad_reduced, to_placements,
)
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
    impl: str = "dense"  # dense | shard_map (local dispatch per shard)

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
    """xs: (E, C, d) -> (E, C, d) grouped GEMMs (block-diagonal SpMM).
    Local tensors only; the partitioned program's products are
    :func:`_expert_ffn_split`."""
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
        return apply_moe_shard_map(params, x, spec)
    return apply_moe_dense(params, x, spec)


def _route(xt: torch.Tensor, router: torch.Tensor, spec: MoESpec):
    """Top-k routing of ``xt`` (T, d): (gate values (T, k), expert ids
    (T*k,) token-major, each pair's 0-based slot in its expert, the
    Switch-style load-balancing loss)."""
    e, k = spec.num_experts, spec.top_k
    logits = xt.float() @ router.float()
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
    return gate_vals, flat_e, slot, aux


def _pack(xt: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor,
          spec: MoESpec):
    """Pack the (token, k) pairs within capacity into ``[E, C, d]``:
    (packed, per-pair ``within``, slots with the dropped pairs' at 0)."""
    t, d = xt.shape
    cap = spec.capacity(t)
    within = slot < cap
    tok_ids = torch.arange(t, device=xt.device).repeat_interleave(spec.top_k)
    safe_slot = torch.where(within, slot, 0)
    contrib = torch.where(within[:, None], xt[tok_ids], 0.0)
    xs = torch.zeros((spec.num_experts, cap, d), dtype=xt.dtype,
                     device=xt.device)
    xs.index_put_((flat_e, safe_slot), contrib, accumulate=True)  # pack
    return xs, within, safe_slot


def _combine(ys: torch.Tensor, gate_vals: torch.Tensor, flat_e: torch.Tensor,
             safe_slot: torch.Tensor, within: torch.Tensor):
    """Each token's expert outputs (``ys`` [E, C, d]) weighted by its
    gates and summed: (out (T, d), the gates per pair)."""
    t, k = gate_vals.shape
    gathered = torch.where(within[:, None], ys[flat_e, safe_slot], 0.0)
    gates = gate_vals.reshape(-1)[:, None].to(ys.dtype)
    out = (gathered * gates).reshape(t, k, -1).sum(dim=1)  # segment_sum
    return out, gates


def _dispatch(weights: Params, xt: torch.Tensor, gate_vals: torch.Tensor,
              flat_e: torch.Tensor, slot: torch.Tensor, spec: MoESpec):
    """Pack the pairs within capacity into ``[E, C, d]``, run the expert
    GEMMs on ``weights`` and combine: (out (T, d), per-pair ``within``,
    gates)."""
    xs, within, safe_slot = _pack(xt, flat_e, slot, spec)
    ys = _expert_ffn(weights, xs, spec.mlp_kind)         # (E, C, d)
    out, gates = _combine(ys, gate_vals, flat_e, safe_slot, within)
    return out, within, gates


def _fringe(xt: torch.Tensor, flat_e: torch.Tensor, within: torch.Tensor,
            gates: torch.Tensor, w_in: torch.Tensor,
            w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
            spec: MoESpec) -> torch.Tensor:
    """The fringe pass for dropped pairs: one gather-FFN-scatter over all
    experts, selected per pair (the reference applies the activation only
    for the gated kinds here), weighted by the gates and summed per
    token.  The weights come in ``xt``'s dtype."""
    t, d = xt.shape
    tok_ids = torch.arange(t, device=xt.device).repeat_interleave(spec.top_k)
    dropped = ~within
    fr_x = torch.where(dropped[:, None], xt[tok_ids], 0.0)
    fr_h = torch.einsum("td,edf->tef", fr_x, w_in)
    fr_sel = F.one_hot(flat_e, spec.num_experts).to(xt.dtype)
    if spec.mlp_kind in ("swiglu", "geglu"):
        fr_g = torch.einsum("td,edf->tef", fr_x, w_gate)
        fr_h = _act(spec.mlp_kind)(fr_g) * fr_h
    fr_h = torch.einsum("tef,te->tf", fr_h, fr_sel)
    fr_y = torch.einsum("tf,efd,te->td", fr_h, w_out, fr_sel)
    fr_y = torch.where(dropped[:, None], fr_y, 0.0)
    return (fr_y * gates).reshape(t, spec.top_k, d).sum(dim=1)


def _shared_expert(params: Params, xt: torch.Tensor) -> torch.Tensor:
    g = grad_reduced(xt) @ gather_weight(params["shared_w_gate"], xt.dtype)
    hh = grad_reduced(xt) @ gather_weight(params["shared_w_in"], xt.dtype)
    return constrain((silu(g) * hh)
                     @ gather_weight(params["shared_w_out"], xt.dtype),
                     "batch", None)


def apply_moe_dense(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    spec: MoESpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). Sort-based capacity dispatch."""
    if hasattr(x, "placements"):
        return _moe_dense_partitioned(params, x, spec)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)

    gate_vals, flat_e, slot, aux = _route(xt, params["router"], spec)
    out, within, gates = _dispatch(params, xt, gate_vals, flat_e, slot,
                                   spec)

    if spec.fringe_overflow:
        w_gate = params.get("w_gate")
        out = out + _fringe(
            xt, flat_e, within, gates, params["w_in"].to(x.dtype),
            None if w_gate is None else w_gate.to(x.dtype),
            params["w_out"].to(x.dtype), spec)

    if spec.shared_expert:
        out = out + _shared_expert(params, xt)

    return out.reshape(b, s, d).to(x.dtype), aux


def _moe_dense_partitioned(params: Params, x: torch.Tensor, spec: MoESpec
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense MoE of a partitioned program, as XLA's SPMD partitioner
    lays out the reference's: routing (logits, top-k, the slot cumsum
    over every token) runs on the whole batch, gathered and replicated;
    the dispatch is split along d over the mesh axes that split the
    expert weights' d (the FSDP axes; ``data`` of the dry run's meshes,
    also a batch axis): each device packs its d slice of every pair into
    ``(E, C, d / n)``, its products contract that slice and sum the
    ``(E, C, ff / TP)`` hidden slots over those axes, the ``w_out``
    product is summed over TP, and the combine gathers the d-split
    outputs into ``(T, d / n)``, moved back to each device's rows with d
    whole.  The fringe pass runs on the whole batch, the shared expert
    on each device's rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    b, s, d = x.shape
    t = b * s
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim      # a list: one output's placements
    w_in_pl = tuple(getattr(params["w_in"], "placements", rep))
    split = [i for i, p in enumerate(w_in_pl) if p == Shard(1)]
    if d % math.prod(mesh.size(i) for i in split):
        split = []

    def d_pl(dim):
        """The placements of slots or rows whose ``dim`` is d."""
        return [Shard(dim) if i in split else Replicate()
                for i in range(mesh.ndim)]

    xt = to_placements(x, tuple(rep)).reshape(t, d)
    router = to_placements(params["router"], tuple(rep))
    gate_vals, flat_e, slot, aux = local_map(
        functools.partial(_route, spec=spec), out_placements=(rep,) * 4,
        in_placements=(rep, rep), device_mesh=mesh)(xt, router)
    xs, within, safe_slot = local_map(
        functools.partial(_pack, spec=spec),
        out_placements=(d_pl(2), rep, rep),
        in_placements=(d_pl(1), rep, rep), device_mesh=mesh)(
            to_placements(xt, tuple(d_pl(1))), flat_e, slot)
    ys = _expert_ffn_split(params, xs, spec.mlp_kind, split)
    # each device's gates meet its d slice only: their gradient is
    # partial over ``split``
    gate_grad = [Partial() if i in split else Replicate()
                 for i in range(mesh.ndim)]
    out = local_map(
        lambda *a: _combine(*a)[0], out_placements=d_pl(1),
        in_placements=(d_pl(2), rep, rep, rep, rep),
        in_grad_placements=(d_pl(2), gate_grad, rep, rep, rep),
        device_mesh=mesh)(ys, gate_vals, flat_e, safe_slot, within)
    if spec.fringe_overflow:
        # every device runs the fringe pass on the whole batch, with the
        # expert weights gathered
        w = [None if k not in params else to_placements(
            params[k].to(x.dtype), tuple(rep))
            for k in ("w_in", "w_gate", "w_out")]
        w_pl = [None if v is None else rep for v in w]
        gates = gate_vals.reshape(-1, 1).to(x.dtype)
        out = out + local_map(
            functools.partial(_fringe, spec=spec), out_placements=rep,
            in_placements=(rep,) * 4 + tuple(w_pl),
            device_mesh=mesh)(xt, flat_e, within, gates, *w)
    # to each device's rows: the batch split of the other axes first (a
    # local slice), then d to rows over ``split`` (an all-to-all; in one
    # move DTensor gathers over ``split`` where another axis splits rows)
    x_pl = tuple(x.placements)
    out = to_placements(out.reshape(b, s, d), tuple(
        Shard(2) if i in split else p for i, p in enumerate(x_pl)))
    out = to_placements(out, x_pl)
    if spec.shared_expert:
        out = out + _shared_expert(params, x.reshape(t, d)).reshape(b, s, d)
    return out.to(x.dtype), aux


def _expert_ffn_split(params: Params, xs: torch.Tensor, kind: str,
                      split) -> torch.Tensor:
    """:func:`_expert_ffn` on slots split along d over the mesh dims
    ``split``, each product on local blocks: the weights are cast and
    placed with d split there too (their FSDP split) and ff over TP (any
    other FSDP split gathered); the ``w_in``/``w_gate`` products leave
    ``(E, C, ff / TP)`` partial over ``split``, summed there (XLA's
    all-reduce at ``ecd,edf->ecf``), and the ``w_out`` product
    ``(E, C, d / n)`` partial over TP, summed there (at
    ``ecf,efd->ecd``).  Each weight's gradient is complete on its block:
    every device holds every slot."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xs.device_mesh
    tp = [i for i, p in enumerate(params["w_in"].placements) if p == Shard(2)]

    def pl(split_p, tp_p):
        return [split_p if i in split else tp_p if i in tp else Replicate()
                for i in range(mesh.ndim)]

    def weight(name, d_dim, ff_dim):
        return to_placements(params[name].to(xs.dtype), tuple(
            pl(Shard(d_dim), Shard(ff_dim))))

    gated = kind in ("swiglu", "geglu")
    w_in = [weight("w_in", 1, 2)] + ([weight("w_gate", 1, 2)] if gated
                                     else [])
    xs_pl, w_pl = pl(Shard(2), Replicate()), pl(Shard(1), Shard(2))
    hs = local_map(
        lambda x, *ws: tuple(torch.bmm(x, w) for w in ws),
        out_placements=(pl(Partial(), Shard(2)),) * len(w_in),
        in_placements=(xs_pl,) + (w_pl,) * len(w_in),
        in_grad_placements=(pl(Shard(2), Partial()),) + (w_pl,) * len(w_in),
        device_mesh=mesh)(xs, *w_in)
    # the activation runs on the summed blocks; its gradient, like the
    # w_out product's, is partial over ``split`` (each device's d slice)
    h_pl = pl(Replicate(), Shard(2))
    hs = [to_placements(h, tuple(h_pl)) for h in hs]
    w_out_pl = pl(Shard(2), Shard(1))

    def out_body(w_out, h, g=None):
        if gated:
            h = _act(kind)(g) * h
        elif kind == "squared_relu":
            h = torch.square(F.relu(h))
        else:
            h = gelu(h)
        return torch.bmm(h, w_out)

    y = local_map(
        out_body, out_placements=pl(Shard(2), Partial()),
        in_placements=(w_out_pl,) + (h_pl,) * len(hs),
        in_grad_placements=(w_out_pl,) + (pl(Partial(), Shard(2)),) * len(hs),
        device_mesh=mesh)(weight("w_out", 2, 1), *hs)
    return to_placements(y, tuple(xs_pl))


def _gathered(w: torch.Tensor, dim: int, n: int,
              device: torch.device) -> torch.Tensor:
    """``w`` as an all-gather over ``n`` FSDP shards gives it on
    ``device``: the shards' slices along ``dim``, concatenated."""
    return torch.cat([piece.to(device) for piece in w.chunk(n, dim=dim)],
                     dim=dim)


def apply_moe_shard_map(
    params: Params,
    x: torch.Tensor,  # (B, S, D) — batch split over the DP axes
    spec: MoESpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local dispatch per shard of the ambient mesh, as the reference's
    ``shard_map`` block runs it.

    Every (data, model) shard packs only its local tokens, at
    ``capacity(t_local)``, runs the expert GEMMs on its slice of the ff
    dimension, and combines locally; the shards' outputs are summed over
    the TP axis (the reference's ``psum``) and concatenated over the DP
    axes, and the load-balancing loss is averaged over the shards (its
    ``pmean``).  With ``moe_fsdp`` the weights enter split over the FSDP
    axes along d, cast to the compute dtype first, and are gathered inside
    each shard; without it they are replicated over DP.  The shared
    expert runs on the whole batch after the block.

    Needs installed :class:`~repro_torch.distributed.sharding.AxisRules`
    (``use_rules``) and a mesh (``distributed.mesh.use_mesh``) whose axes
    they name.  Shards run one after another from this process, each on
    its mesh device; the result lands on ``x``'s device.
    """
    from ..distributed.mesh import active_mesh
    from ..distributed.sharding import active_rules

    if hasattr(x, "placements"):
        return _moe_shard_map_partitioned(params, x, spec)
    rules, mesh = active_rules(), active_mesh()
    if rules is None or mesh is None:
        raise RuntimeError(
            "the shard_map MoE needs installed AxisRules "
            "(distributed.sharding.use_rules) and a mesh "
            "(distributed.mesh.use_mesh)")
    sizes = mesh.shape
    dp_axes = tuple(rules.batch_axes)
    tp = rules.tp_axis
    fsdp_axes = tuple(rules.fsdp_axes) if rules.moe_fsdp else ()
    n_dp = math.prod(sizes[a] for a in dp_axes)
    n_tp = sizes[tp] if tp else 1
    n_fsdp = math.prod(sizes[a] for a in fsdp_axes)
    b, s, d = x.shape
    f = params["w_in"].shape[-1]
    if b % n_dp or f % n_tp or d % n_fsdp:
        raise ValueError(
            f"batch {b}, d_expert {f} and d_model {d} must divide over "
            f"{n_dp} data, {n_tp} model and {n_fsdp} FSDP shards")
    bl, fl = b // n_dp, f // n_tp
    w_gate = params.get("w_gate", params["w_in"])

    outs, auxes = [], []
    for i in range(n_dp):
        # the data shard's coordinates over the DP axes, row-major
        coords, rest = {}, i
        for a in reversed(dp_axes):
            coords[a], rest = rest % sizes[a], rest // sizes[a]
        partial = None
        for j in range(n_tp):
            if tp:
                coords[tp] = j
            dev = mesh.device(coords)
            ff = slice(j * fl, (j + 1) * fl)
            local = {"w_in": params["w_in"][:, :, ff],
                     "w_gate": w_gate[:, :, ff],
                     "w_out": params["w_out"][:, ff, :]}
            if n_fsdp > 1:
                local = {k: _gathered(w.to(x.dtype), 2 if k == "w_out" else 1,
                                      n_fsdp, dev)
                         for k, w in local.items()}
            else:
                local = {k: w.to(dev) for k, w in local.items()}
            xt = x[i * bl:(i + 1) * bl].to(dev).reshape(bl * s, d)
            gate_vals, flat_e, slot, aux = _route(
                xt, params["router"].to(dev), spec)
            out, *_ = _dispatch(local, xt, gate_vals, flat_e, slot, spec)
            out = out.to(x.device)
            partial = out if partial is None else partial + out  # psum
            if j == 0:
                auxes.append(aux.to(x.device))
        outs.append(partial.reshape(bl, s, d))
    out = torch.cat(outs, dim=0)
    aux = torch.stack(auxes).sum() / n_dp                       # pmean

    if spec.shared_expert:
        out = out + _shared_expert(params, x.reshape(b * s, d)).reshape(
            b, s, d)
    return out.to(x.dtype), aux


def _moe_shard_map_partitioned(params: Params, x: torch.Tensor,
                               spec: MoESpec
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``shard_map`` MoE of a partitioned program: the block body runs
    once, on this device's tokens and its ff slice of the expert weights
    (``local_map``, the counterpart of ``jax.shard_map``); the weights
    enter gathered over FSDP (``moe_fsdp``) after the cast, the output is
    summed over TP (the reference's ``psum``) and the load-balancing loss
    averaged over the batch axes (its ``pmean``), each an explicit
    collective."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import active_rules

    rules = active_rules()
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    b, s, d = x.shape
    w_gate = params.get("w_gate", params["w_in"])
    weights = {k: gather_weight(w, x.dtype) for k, w in
               (("w_in", params["w_in"]), ("w_gate", w_gate),
                ("w_out", params["w_out"]))}
    tp = names.index(rules.tp_axis) if rules.tp_axis in names else None
    x_pl = tuple(x.placements)
    batch_dims = [i for i, p in enumerate(x_pl) if p.is_shard(0)]
    n_b = math.prod(mesh.size(i) for i in batch_dims)
    first_tp = tp is None or mesh.get_coordinate()[tp] == 0
    # each output is partial over TP (an ff slice); the loss is each data
    # shard's over n_b, counted on the first TP shard only, so that
    # summing over the mesh gives the mean, and its gradient reaches the
    # router once
    out_pl = [Partial() if i == tp else p for i, p in enumerate(x_pl)]
    aux_pl = [Partial() if i == tp or i in batch_dims else Replicate()
              for i in range(mesh.ndim)]
    rep = (Replicate(),) * mesh.ndim
    router = to_placements(params["router"], rep)

    def body(x, router, w_in, w_gate, w_out):
        bl = x.shape[0]
        xt = x.reshape(bl * s, d)
        gate_vals, flat_e, slot, aux = _route(xt, router, spec)
        local = {"w_in": w_in, "w_gate": w_gate, "w_out": w_out}
        out, *_ = _dispatch(local, xt, gate_vals, flat_e, slot, spec)
        aux = aux / n_b if first_tp else aux * 0.0
        return out.reshape(bl, s, d), aux

    w_pl = [tuple(weights[k].placements) for k in ("w_in", "w_gate",
                                                   "w_out")]
    for pl in w_pl:   # only the ff split over TP may remain
        if any(p.is_shard() and i != tp for i, p in enumerate(pl)):
            raise ValueError(f"shard_map MoE weights placed {pl}")
    # the gradients a shard computes are its own tokens' (partial over
    # the batch axes) through its own ff slice (partial over TP)
    x_grad = [Partial() if i == tp else p for i, p in enumerate(x_pl)]
    w_grad = [tuple(Partial() if i in batch_dims else p
                    for i, p in enumerate(pl)) for pl in w_pl]
    out, aux = local_map(
        body, out_placements=(out_pl, aux_pl),
        in_placements=(x_pl, rep, *w_pl),
        in_grad_placements=(x_grad, (Partial(),) * mesh.ndim, *w_grad),
        device_mesh=mesh)(x, router, weights["w_in"], weights["w_gate"],
                          weights["w_out"])
    out = to_placements(out, x_pl)                                  # psum
    aux = to_placements(aux, rep)                                   # pmean
    if spec.shared_expert:
        out = out + _shared_expert(params, x.reshape(b * s, d)).reshape(
            b, s, d)
    return out.to(x.dtype), aux
