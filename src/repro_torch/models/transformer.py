"""Composable decoder/encoder stack covering all 10 assigned architectures.

A port of ``repro.models.transformer``.  Layers are organised into *groups*
matching the arch's repeating pattern (e.g. gemma2 = (local, global),
zamba2 = 5×ssm + shared-attn).  The parameter layout is the reference's:
``groups/slot{i}`` leaves stacked on a leading ``n_groups`` axis,
``tail/slot{i}`` for the remainder, and ``shared`` for zamba2's shared
attention block, so weights carry over one to one.  The groups run as a
Python loop (the reference scans over them) over per-group views that
:func:`split_groups` takes once per call with ``torch.unbind``: under
autograd the views' gradients then meet in one ``UnbindBackward``, which
stacks them, where indexing each leaf ``a[g]`` would write a zero-filled
gradient of the whole stacked leaf per group and sum ``n_groups`` of them.

``cfg.remat == "full"`` recomputes each group in the backward
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps its
group body in ``jax.checkpoint``: when grad is enabled and no cache is
passed.  Then a step keeps only the groups' inputs, not their
activations.

Layer kinds:
  "attn"        attention + dense MLP
  "attn_moe"    attention + MoE FFN
  "ssm"         Mamba2 SSD block
  "shared_attn" an application of the stack-shared attention block (zamba2)

Caches are updated in place: a group's slice of a stacked KV cache is a
view, and the SSM state and conv tail are copied into theirs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (
    constrain, gather_weight, grad_reduced,
)
from . import layers, moe as moe_lib, ssm as ssm_lib
from .config import ModelConfig
from .layers import Init

Params = Dict[str, Any]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor leaf of a nested dict (empty dicts kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------
def _attn_spec(cfg: ModelConfig, kind_idx: int) -> layers.AttnSpec:
    pat = cfg.attn_pattern[kind_idx % len(cfg.attn_pattern)] if cfg.attn_pattern else "global"
    return layers.AttnSpec(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        causal=not cfg.encoder_only,
        window=cfg.window if pat == "local" else None,
        softcap=cfg.attn_softcap,
        kv_chunk=cfg.kv_chunk,
        unroll=cfg.attn_unroll,
    )


def init_layer(init: Init, cfg: ModelConfig, kind: str, kind_idx: int) -> Params:
    p: Params = {"norm1": layers.init_rms_norm(init, cfg.d_model)}
    if kind == "ssm":
        p["ssm"] = ssm_lib.init_ssm(init, cfg.ssm_spec())
    elif kind in ("attn", "attn_moe"):
        p["attn"] = layers.init_attention(init, _attn_spec(cfg, kind_idx))
        p["norm2"] = layers.init_rms_norm(init, cfg.d_model)
        if kind == "attn_moe":
            p["moe"] = moe_lib.init_moe(init, cfg.moe_spec())
        else:
            p["mlp"] = layers.init_mlp(init, cfg.d_model, cfg.d_ff, cfg.mlp_kind)
    elif kind == "shared_attn":
        # per-application input projection only; block weights are shared
        p["adapter"] = init.normal((cfg.d_model, cfg.d_model),
                                   0.1 / np.sqrt(cfg.d_model))
    else:
        raise ValueError(kind)
    return p


def apply_layer(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    kind_idx: int,
    positions: torch.Tensor,
    cache: Optional[Any],
    shared: Optional[Params],
) -> Tuple[torch.Tensor, Optional[Any], torch.Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        h, new_state = ssm_lib.apply_ssm(
            params["ssm"], layers.rms_norm(params["norm1"], x, cfg.norm_eps),
            cfg.ssm_spec(), state=cache,
        )
        return x + h, new_state, aux
    if kind == "shared_attn":
        spec = _attn_spec(cfg, kind_idx)
        xin = layers.rms_norm(params["norm1"], x, cfg.norm_eps)
        xin = xin + constrain(
            grad_reduced(xin) @ gather_weight(params["adapter"], x.dtype),
            "batch", "seq", None)
        h, new_cache = layers.apply_attention(
            shared["attn"], xin, spec, positions, cache=cache
        )
        return x + h, new_cache, aux
    # attn / attn_moe
    spec = _attn_spec(cfg, kind_idx)
    h, new_cache = layers.apply_attention(
        params["attn"], layers.rms_norm(params["norm1"], x, cfg.norm_eps),
        spec, positions, cache=cache,
    )
    x = x + h
    xin = layers.rms_norm(params["norm2"], x, cfg.norm_eps)
    if kind == "attn_moe":
        h, aux = moe_lib.apply_moe(params["moe"], xin, cfg.moe_spec())
    else:
        h = layers.apply_mlp(params["mlp"], xin, cfg.mlp_kind)
    return x + h, new_cache, aux


# ---------------------------------------------------------------------------
# cache containers
# ---------------------------------------------------------------------------
def init_layer_cache(
    cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
    device=None, lead: Tuple[int, ...] = (),
) -> Any:
    if kind == "ssm":
        ssd, conv = ssm_lib.init_ssm_state(batch, cfg.ssm_spec(),
                                           torch.float32, device)
        return {"ssd": ssd.expand(lead + ssd.shape).clone(),
                "conv": conv.expand(lead + conv.shape).clone()}
    if kind in ("attn", "attn_moe", "shared_attn"):
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        shape = lead + (batch, max_len, kv, hd)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
def layer_plan(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """Returns (group_pattern, num_groups, tail_pattern)."""
    pattern = cfg.group_pattern()
    g = len(pattern)
    return pattern, cfg.num_layers // g, tuple(pattern[: cfg.num_layers % g])


def init_stack(init: Init, cfg: ModelConfig) -> Params:
    pattern, n_groups, tail = layer_plan(cfg)
    p: Params = {"groups": {}, "tail": {}}
    if n_groups:
        stacked = dataclasses.replace(init, lead=init.lead + (n_groups,))
        for slot, kind in enumerate(pattern):
            p["groups"][f"slot{slot}"] = init_layer(stacked, cfg, kind, slot)
    for slot, kind in enumerate(tail):
        p["tail"][f"slot{slot}"] = init_layer(init, cfg, kind, slot)
    if cfg.has_shared_attn():
        p["shared"] = {"attn": layers.init_attention(init, _attn_spec(cfg, 0))}
    return p


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None) -> Any:
    pattern, n_groups, tail = layer_plan(cfg)
    cache: Dict[str, Any] = {"groups": {}, "tail": {}}
    if n_groups:
        for slot, kind in enumerate(pattern):
            cache["groups"][f"slot{slot}"] = init_layer_cache(
                cfg, kind, batch, max_len, dtype, device, lead=(n_groups,))
    for slot, kind in enumerate(tail):
        cache["tail"][f"slot{slot}"] = init_layer_cache(
            cfg, kind, batch, max_len, dtype, device)
    return cache


def _run_layer(lp: Params, lc: Optional[Dict[str, torch.Tensor]],
               x: torch.Tensor, cfg: ModelConfig, kind: str, slot: int,
               positions: torch.Tensor, cache_len: Optional[int],
               shared: Optional[Params]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer; with a cache ``lc`` (a dict of views), its new state is
    written back into ``lc`` in place."""
    layer_cache = None
    if lc is not None:
        if kind == "ssm":
            layer_cache = (lc["ssd"], lc["conv"])
        else:
            layer_cache = (lc["k"], lc["v"], cache_len)
    x, new_c, aux = apply_layer(lp, x, cfg, kind, slot, positions,
                                layer_cache, shared)
    if lc is not None and kind == "ssm":
        lc["ssd"].copy_(layers._like(new_c[0], lc["ssd"]))
        lc["conv"].copy_(layers._like(new_c[1], lc["conv"]))
    return x, aux


def split_groups(tree: Any, n_groups: int) -> list:
    """``n_groups`` trees of views, group ``g``'s the ``[g]`` slice of
    every stacked leaf (one ``torch.unbind`` per leaf)."""
    if isinstance(tree, dict):
        parts = {k: split_groups(v, n_groups) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n_groups)]
    return list(torch.unbind(tree, 0))


def apply_stack(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Optional[Any] = None,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Any], torch.Tensor]:
    """Runs all layers. cache (+cache_len) switches decode mode; the cache
    is updated in place and returned."""
    pattern, n_groups, tail = layer_plan(cfg)
    shared = params.get("shared")
    use_cache = cache is not None
    if use_cache:
        cache_len = int(cache_len)
    remat = cfg.remat == "full" and not use_cache and torch.is_grad_enabled()

    def group(gp, gc, x, aux):
        for slot, kind in enumerate(pattern):
            key = f"slot{slot}"
            lc = gc[key] if use_cache else None
            x, a = _run_layer(gp[key], lc, x, cfg, kind, slot, positions,
                              cache_len, shared)
            aux = aux + a
        # sequence-parallel residual between groups (no-op unless seq_axis)
        return constrain(x, "batch", "seq", None), aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if n_groups:
        gps = split_groups(params["groups"], n_groups)
        # the cache's groups as select views, which may be written in
        # place (unbind's multi-output views may not be, under autograd)
        gcs = ([tree_map(lambda a: a[g], cache["groups"])
                for g in range(n_groups)] if use_cache
               else [None] * n_groups)
        for gp, gc in zip(gps, gcs):
            if remat:
                x, aux = checkpoint(group, gp, gc, x, aux,
                                    use_reentrant=False)
            else:
                x, aux = group(gp, gc, x, aux)
    for slot, kind in enumerate(tail):
        key = f"slot{slot}"
        lc = cache["tail"][key] if use_cache else None
        x, a = _run_layer(params["tail"][key], lc, x, cfg, kind, slot,
                          positions, cache_len, shared)
        aux = aux + a
    return x, cache, aux
