"""Cell builder: for each (arch x shape x mesh) the step function, its
``meta`` tensor inputs and their shardings, shared by the dry run, the
roofline probes and the perf hillclimb.  A port of
``repro.launch.specs``.

``meta`` tensors take the place of ``jax.ShapeDtypeStruct``: params from
``model.init_params(cfg, None, "meta")``, optimizer state, caches and
batches made on ``meta``.  The shardings are
:class:`~repro_torch.distributed.sharding.NamedSharding`\\ s over the
port's mesh; ``fn`` runs the port's step (``train_loop.make_train_step``,
``model.prefill``, ``model.forward`` or ``model.decode_step``) under the
cell's rules and mesh.  With ``partitioned=True`` the cell is a DTensor
program: its args are placed by ``in_shardings`` over a ``fake``-backend
device mesh with the mesh's names and sizes (``launch.mesh.
fake_dtensor_mesh``, this process as rank 0), and ``fn`` runs under that
mesh (``distributed.sharding.use_dtensor_mesh``), so a trace of it runs
one device's shards and issues its collectives.

``build_cell``'s ``meta`` dict and spec trees equal the reference's, key
for key.  One override is the port's own, for checking the dry run
against one step on a card (``chip_smoke.py``'s phase 13): ``seq_len``,
the cell's sequence length.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import SHAPES, ArchDef
from ..distributed import sharding as shd
from ..distributed.mesh import use_mesh
from ..distributed.sharding import NamedSharding, PartitionSpec as P
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..train import optimizer as opt_lib, train_loop

_META = torch.device("meta")


@dataclasses.dataclass
class CellSpec:
    """Everything needed to trace one dry-run cell."""
    fn: Callable
    args: Tuple  # meta tensors
    in_shardings: Tuple
    out_shardings: Any
    meta: Dict[str, Any]
    # the port's additions: what the dry run reckons from
    cfg: Optional[ModelConfig] = None
    rules: Optional[shd.AxisRules] = None
    mesh: Any = None
    # the torch DeviceMesh the args are placed over (partitioned cells)
    dmesh: Any = None


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_structs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    if cfg.frontend == "audio":
        return {
            "frames": _sds((batch, seq, cfg.frontend_dim), torch.bfloat16),
            "labels": _sds((batch, seq), torch.int32),
        }
    if cfg.frontend == "vision":
        s_text = seq - cfg.num_patches
        return {
            "tokens": _sds((batch, s_text), torch.int32),
            "patches": _sds((batch, cfg.num_patches, cfg.frontend_dim),
                            torch.bfloat16),
        }
    return {"tokens": _sds((batch, seq), torch.int32)}


def batch_spec_tree(batch_structs_tree, rules, sizes):
    return {k: shd.batch_spec(rules, leaf.shape[0], leaf.ndim - 1, sizes)
            for k, leaf in batch_structs_tree.items()}


def default_rules(mesh) -> shd.AxisRules:
    multi = "pod" in mesh.axis_names
    return shd.AxisRules(
        batch_axes=("pod", "data") if multi else ("data",),
        fsdp_axes=("data",),
        tp_axis="model",
    )


def optimized_cell_config(arch: ArchDef, shape_name: str, mesh):
    """Winning §Perf configuration per cell kind (beyond-paper defaults).

    - serve cells: TP-only bf16 weights (no per-token FSDP gathers) when the
      TP-sharded weights fit; big-model serving keeps FSDP.
    - MoE train cells: shard_map local dispatch; small expert sets are
      DP-replicated, 100B-scale experts keep FSDP with in-block bf16 gather.
    Returns (rules, overrides).
    """
    kind = SHAPES[shape_name].kind
    multi = "pod" in mesh.axis_names
    batch = ("pod", "data") if multi else ("data",)
    cfg = arch.full
    small_experts = bool(cfg.moe_num_experts) and (
        cfg.moe_num_experts * cfg.d_model * (cfg.moe_d_expert or cfg.d_ff)
        * 3 * 4 <= 2**30)
    if kind in ("prefill", "decode"):
        ov = {"param_dtype": torch.bfloat16}
        if small_experts:  # dispatch blowup hits serving too
            ov["moe_impl"] = "shard_map"
        tp = dict(mesh.shape).get("model", 1)
        bf16_per_dev_gb = cfg.param_count() * 2 / tp / 2**30
        if bf16_per_dev_gb <= 12:  # fits TP-only
            return (
                shd.AxisRules(batch_axes=batch, fsdp_axes=(), tp_axis="model",
                              moe_fsdp=not small_experts),
                ov,
            )
        return (  # 340B-class: keep FSDP for weights, bf16 for the math
            shd.AxisRules(batch_axes=batch, fsdp_axes=("data",),
                          tp_axis="model"),
            {"param_dtype": torch.bfloat16},
        )
    # train
    overrides = {}
    if cfg.moe_num_experts:
        overrides["moe_impl"] = "shard_map"
    rules = shd.AxisRules(batch_axes=batch, fsdp_axes=("data",),
                          tp_axis="model", moe_fsdp=not small_experts)
    return rules, overrides


def _ns(mesh, spec_tree):
    return shd._map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def _in_context(fn, rules, mesh, dmesh=None):
    """``fn`` under the cell's rules and ambient mesh (the shard_map MoE
    reads both), and under ``dmesh`` for a partitioned cell."""
    def run(*args):
        with shd.use_rules(rules), use_mesh(mesh), \
                shd.use_dtensor_mesh(dmesh):
            return fn(*args)
    run.__wrapped__ = fn
    return run


def partition(cell: CellSpec, device_type: str = "cuda") -> CellSpec:
    """``cell`` as a partitioned DTensor program: its args placed by its
    ``in_shardings`` over a ``fake`` device mesh of its mesh's names and
    sizes (rank 0), its ``fn`` run under that mesh."""
    from .mesh import fake_dtensor_mesh

    dmesh = fake_dtensor_mesh(cell.mesh, device_type)
    args = shd.place(cell.args, cell.in_shardings, dmesh)
    return dataclasses.replace(
        cell, args=args, dmesh=dmesh,
        fn=_in_context(cell.fn.__wrapped__, cell.rules, cell.mesh, dmesh))


def build_cell(
    arch: ArchDef,
    shape_name: str,
    mesh,
    rules: Optional[shd.AxisRules] = None,
    overrides: Optional[Dict[str, Any]] = None,
    analysis_mode: bool = True,
    partitioned: bool = False,
) -> CellSpec:
    """Build the step + specs for one cell.

    ``overrides`` patches ModelConfig fields (hillclimb knob), besides
    ``num_microbatches``, ``global_batch``, ``kv_cache_dtype`` and the
    port's ``seq_len``.  ``analysis_mode`` sets the
    reference's unroll fields (``scan_layers``, ``attn_unroll``), which
    the port reads not: it runs layers, microbatches and KV chunks as
    Python loops either way, and its counts are exact at any depth.  The
    reference's analysis KV chunk (2,048, or 8,192 for decode) is left
    out: attention pads K and V to whole chunks, so the chunk changes the
    work, and the probes count the program that runs.  ``partitioned``
    returns the cell as a DTensor program (:func:`partition`).
    """
    cell = _build_cell(arch, shape_name, mesh, rules, overrides,
                       analysis_mode)
    return partition(cell) if partitioned else cell


def _build_cell(arch, shape_name, mesh, rules, overrides, analysis_mode
                ) -> CellSpec:
    cell = SHAPES[shape_name]
    cfg = arch.full
    overrides = dict(overrides or {})
    micro_override = overrides.pop("num_microbatches", None)
    gb_override = overrides.pop("global_batch", None)
    kv_dtype_override = overrides.pop("kv_cache_dtype", None)
    seq_override = overrides.pop("seq_len", None)
    if kv_dtype_override:
        arch = dataclasses.replace(arch, kv_cache_dtype=kv_dtype_override)
    if gb_override:
        cell = dataclasses.replace(cell, global_batch=gb_override)
    if seq_override:
        cell = dataclasses.replace(cell, seq_len=seq_override)
    if analysis_mode:
        cfg = dataclasses.replace(cfg, scan_layers=False, attn_unroll=1 << 20)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rules = rules or default_rules(mesh)
    sizes = dict(mesh.shape)

    params_struct = model_lib.init_params(cfg, None, _META)
    pspecs = shd.param_specs(params_struct, rules, sizes)

    meta: Dict[str, Any] = {
        "arch": arch.name,
        "shape": shape_name,
        "kind": cell.kind,
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
    }
    extra = {"cfg": cfg, "rules": rules, "mesh": mesh}
    batch_axes = shd._batch_axes_fit(rules, cell.global_batch, sizes)

    if cell.kind == "train":
        n_micro = micro_override or arch.microbatches.get(shape_name, 1)
        tcfg = train_loop.TrainConfig(
            optimizer=opt_lib.OptimizerConfig(moment_dtype=torch.bfloat16),
            num_microbatches=n_micro,
            unroll_microbatches=analysis_mode,
        )
        meta["microbatches"] = n_micro
        step = train_loop.make_train_step(cfg, tcfg)
        for leaf in opt_lib.tree_leaves(params_struct):
            leaf.requires_grad_(True)
        opt_struct = opt_lib.init_opt_state(params_struct, tcfg.optimizer)
        ospecs = opt_lib.OptState(
            step=P(),
            m=shd.param_specs(opt_struct.m, rules, sizes),
            v=shd.param_specs(opt_struct.v, rules, sizes),
        )
        bstruct = batch_structs(cfg, cell.global_batch, cell.seq_len)
        bspecs = batch_spec_tree(bstruct, rules, sizes)
        return CellSpec(
            fn=_in_context(step, rules, mesh),
            args=(params_struct, opt_struct, bstruct),
            in_shardings=(_ns(mesh, pspecs), _ns(mesh, ospecs),
                          _ns(mesh, bspecs)),
            out_shardings=(_ns(mesh, pspecs), _ns(mesh, ospecs),
                           {k: NamedSharding(mesh, P())
                            for k in ("loss", "grad_norm", "lr")}),
            meta=meta, **extra,
        )

    if cell.kind == "prefill":
        bstruct = batch_structs(cfg, cell.global_batch, cell.seq_len)
        bspecs = batch_spec_tree(bstruct, rules, sizes)
        if cfg.encoder_only:
            def fwd(params, batch):
                logits, _ = model_lib.forward(params, batch, cfg)
                return logits
            out_spec = NamedSharding(mesh, P(batch_axes, None, None))
            return CellSpec(_in_context(_no_grad(fwd), rules, mesh),
                            (params_struct, bstruct),
                            (_ns(mesh, pspecs), _ns(mesh, bspecs)), out_spec,
                            meta, **extra)

        cache_struct = model_lib.init_cache(
            cfg, cell.global_batch, cell.seq_len + 8, _cache_dtype(arch),
            _META)
        cspecs = shd.cache_specs(cache_struct, rules, sizes)

        def pre(params, batch, cache):
            return model_lib.prefill(params, batch, cfg, cache)

        return CellSpec(
            fn=_in_context(_no_grad(pre), rules, mesh),
            args=(params_struct, bstruct, cache_struct),
            in_shardings=(_ns(mesh, pspecs), _ns(mesh, bspecs),
                          _ns(mesh, cspecs)),
            out_shardings=(NamedSharding(mesh, P(batch_axes, None)),
                           _ns(mesh, cspecs)),
            meta=meta, **extra,
        )

    # decode: one new token against a cache of seq_len
    cache_struct = model_lib.init_cache(cfg, cell.global_batch, cell.seq_len,
                                        _cache_dtype(arch), _META)
    cspecs = shd.cache_specs(cache_struct, rules, sizes)
    tok_struct = _sds((cell.global_batch, 1), torch.int32)
    tok_spec = P(batch_axes, None)
    # the reference traces the length as a scalar; the port's decode reads
    # it as a Python int: the cache's last slot (any length inside the
    # cache dispatches the same ops, chunk for chunk)
    cache_len = cell.seq_len - 1
    meta["kv_cache_dtype"] = arch.kv_cache_dtype

    def dec(params, token, cache, length):
        return model_lib.decode_step(params, token, cache, length, cfg)

    return CellSpec(
        fn=_in_context(_no_grad(dec), rules, mesh),
        args=(params_struct, tok_struct, cache_struct, cache_len),
        in_shardings=(_ns(mesh, pspecs), NamedSharding(mesh, tok_spec),
                      _ns(mesh, cspecs), NamedSharding(mesh, P())),
        out_shardings=(NamedSharding(mesh, P(batch_axes, None)),
                       _ns(mesh, cspecs)),
        meta=meta, **extra,
    )


def _no_grad(fn):
    """Inference cells run without autograd, as the serve engine does."""
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def _cache_dtype(arch: ArchDef):
    return torch.int8 if arch.kv_cache_dtype == "int8" else torch.bfloat16
