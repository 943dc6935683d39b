"""The reference side of ``tests/test_torch_launch.py``: the JAX package's
launch tooling in a process of its own with 512 forced host devices, so
the device count never leaks into other tests.  Prints one JSON object:
the mesh shapes; the tiny train cell on the 2 x 4 debug mesh, compiled
as ``build_cell``'s analysis mode builds it (layers and microbatches
unrolled, bf16 moments): its shard shapes, compiled argument and temp
bytes and the collectives of its module after SPMD partitioning (by
``hlo_analysis.collective_bytes``, and op by op with the shapes of their
results and operands); the same for a tiny MoE cell (both
implementations), a tiny SSM cell and a tiny dense cell whose 6 heads do
not divide over TP = 4, and the dense MoE's tiny cell as a prefill step
under ``specs.default_rules`` (on 2 x 4, and on 2 x 4 x 1 with a pod
axis); every arch x shape cell's ``applicable``,
``build_cell`` meta and sharding specs on the 16 x 16 mesh (through
``jax.eval_shape``; nothing is compiled there), the model-FLOPs formula
per cell, and the perf hillclimb's cells.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_launch_reference_worker.py
"""
import glob
import os
import shutil
import tempfile

# the tiny cell's module is dumped after SPMD partitioning: before the
# CPU backend promotes bf16 all-reduces to fp32, turns bf16 collectives
# into fp32 ones and combines all-reduces
DUMP = tempfile.mkdtemp(prefix="launch_ref_")
XLA_FLAGS = (
    "--xla_force_host_platform_device_count=512 "
    f"--xla_dump_to={DUMP} --xla_dump_hlo_as_text "
    "--xla_dump_hlo_module_re=tiny_.*_step "
    "--xla_dump_hlo_pass_re=spmd-partitioning")
os.environ["XLA_FLAGS"] = XLA_FLAGS
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES, get_arch, list_archs  # noqa: E402
from repro.distributed import sharding as shd  # noqa: E402
from repro.launch import dryrun, hlo_analysis, perf, specs  # noqa: E402
from repro.launch.mesh import (  # noqa: E402
    _mesh_kwargs, make_debug_mesh, make_production_mesh, mesh_axis_sizes,
)
from repro.models import model as M  # noqa: E402
from repro.models.config import ModelConfig  # noqa: E402
from repro.train import optimizer as opt_lib, train_loop  # noqa: E402

# repro.launch.dryrun and perf set XLA_FLAGS when imported; the backend
# reads them when first used
os.environ["XLA_FLAGS"] = XLA_FLAGS


def key_str(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def flat_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {key_str(p): spec_json(ns.spec) for p, ns in leaves}


def meshes():
    out = {}
    for name, mesh in (("single", make_production_mesh(multi_pod=False)),
                       ("multi", make_production_mesh(multi_pod=True)),
                       ("debug", make_debug_mesh(2, 4))):
        out[name] = {"shape": list(mesh.devices.shape),
                     "axis_names": list(mesh.axis_names),
                     "sizes": mesh_axis_sizes(mesh)}
    return out


_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^=]*?\)|\S+)\s")


def _operand_shapes(line, start, defined):
    """The shapes of a collective's operands: the names in the
    parenthesised list that opens at ``start``, by the shapes their
    instructions define (``defined``)."""
    depth, end = 0, start
    for end in range(start, len(line)):
        depth += {"(": 1, ")": -1}.get(line[end], 0)
        if depth == 0:
            break
    return [shape for name in re.findall(r"%([\w.\-]+)", line[start:end])
            for shape in defined.get(name, [])]


def partitioned_collectives(hlo_text):
    """[kind, result bytes, result shapes, op_name, operand shapes] of
    each collective of an HLO module, parsed as
    ``hlo_analysis.collective_bytes`` parses it."""
    defined = {}
    for line in hlo_text.splitlines():
        d = _DEF_RE.match(line)
        if d:
            defined[d.group(1)] = hlo_analysis._SHAPE_RE.findall(d.group(2))
    ops = []
    for line in hlo_text.splitlines():
        m = hlo_analysis._OP_RE.search(line)
        if not m or "-done" in line:
            continue
        shapes = hlo_analysis._SHAPE_RE.findall(m.group(1))
        name = re.search(r'op_name="([^"]*)"', line)
        operands = _operand_shapes(line, m.end() - 1, defined)
        ops.append([m.group(2),
                    sum(hlo_analysis._shape_bytes(d, s) for d, s in shapes),
                    " ".join(f"{d}[{s}]" for d, s in shapes),
                    name.group(1) if name else "",
                    " ".join(f"{d}[{s}]" for d, s in operands)])
    return ops


TINY = dict(name="tiny", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=4, d_ff=128, vocab_size=256, kv_chunk=32,
            scan_layers=False, attn_unroll=1 << 20)
# the tiny cells of other families, as tests/test_torch_launch.py builds
# them: granite-moe's family (both MoE implementations), mamba2's, and a
# dense cell whose 6 heads do not divide over TP = 4
TINY_CELLS = {
    "moe_dense": dict(TINY, family="moe", moe_num_experts=4, moe_top_k=2,
                      moe_d_expert=64),
    "moe_shard_map": dict(TINY, family="moe", moe_num_experts=4,
                          moe_top_k=2, moe_d_expert=64,
                          moe_impl="shard_map"),
    "ssm": dict(TINY, family="ssm", ssm_state=16, ssm_head_dim=16,
                ssm_chunk=32),
    "uneven_heads": dict(TINY, family="dense", d_model=96, num_heads=6,
                         num_kv_heads=6, head_dim=16),
}
# the tiny cells compiled as a prefill step (model.prefill into its
# cache): the dense MoE on the 2 x 4 mesh, and on a 2 x 4 x 1 (pod x data
# x model) mesh, whose shard shapes tell which axis splits the dispatch
PREFILL_CELLS = {"moe_dense_prefill": (TINY_CELLS["moe_dense"], (2, 4)),
                 "moe_dense_pod_prefill": (TINY_CELLS["moe_dense"],
                                           (2, 4, 1))}


def _dumped(module):
    (path,) = [f for f in glob.glob(os.path.join(
        DUMP, "*after_spmd-partitioning*"))
        if re.search(rf"jit_{module}\b", f) or f".jit_{module}." in f]
    with open(path) as f:
        return f.read()


def tiny_cell(name="dense", fields=None):
    """``tests/test_dryrun_small.py``'s train cell on the 2 x 4 mesh, as
    ``build_cell(analysis_mode=True)`` builds a cell: layers, KV chunks
    and microbatches unrolled, bf16 moments.  ``fields`` gives another
    family's tiny config (the shard_map MoE's weights DP-replicated, as
    ``optimized_cell_config`` places small experts)."""
    mesh = make_debug_mesh(2, 4)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    fields = dict(fields or dict(TINY, family="dense"))
    rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                          tp_axis="model",
                          moe_fsdp=fields.get("moe_impl") != "shard_map")
    cfg = ModelConfig(**fields)
    tcfg = train_loop.TrainConfig(
        optimizer=opt_lib.OptimizerConfig(moment_dtype=jnp.bfloat16),
        unroll_microbatches=True)
    step = train_loop.make_train_step(cfg, tcfg)
    params = jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0), cfg))
    opt = jax.eval_shape(lambda: opt_lib.init_opt_state(params, tcfg.optimizer))
    pspecs = shd.param_specs(params, rules, sizes)
    ospecs = opt_lib.OptState(step=P(), m=shd.param_specs(opt.m, rules, sizes),
                              v=shd.param_specs(opt.v, rules, sizes))
    batch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32)}
    bspec = {"tokens": P("data", None)}

    def ns(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    in_sh = (ns(pspecs), ns(ospecs), ns(bspec))
    args = (params, opt, batch)
    shard_shapes = {}
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(args)[0],
            jax.tree_util.tree_flatten_with_path(
                in_sh, is_leaf=lambda x: isinstance(x, NamedSharding))[0]):
        shard_shapes[key_str(path)] = list(sh.shard_shape(leaf.shape))

    def tiny_train_step(p, o, b):
        with shd.use_rules(rules):
            return step(p, o, b)

    module = "tiny_train_step" if name == "dense" else f"tiny_{name}_step"
    tiny_train_step.__name__ = tiny_train_step.__qualname__ = module
    ctx = mesh if name == "dense" else jax.set_mesh(mesh)
    with ctx:
        compiled = jax.jit(
            tiny_train_step, in_shardings=in_sh,
            out_shardings=(ns(pspecs), ns(ospecs),
                           jax.tree.map(lambda _: NamedSharding(mesh, P()),
                                        {"loss": 0, "grad_norm": 0, "lr": 0})),
        ).lower(*args).compile()
    mem = compiled.memory_analysis()
    partitioned = _dumped(module)
    out = {"shard_shapes": shard_shapes,
           "argument_bytes": int(mem.argument_size_in_bytes),
           "temp_bytes": int(mem.temp_size_in_bytes),
           "collectives": hlo_analysis.collective_bytes(partitioned),
           "collective_ops": partitioned_collectives(partitioned)}
    if name == "dense":
        named = shd.named_shardings(params, shd.AxisRules(), mesh)
        out["named_shardings"] = flat_specs(named)
    return out


def tiny_prefill(name, fields, shape=(2, 4)):
    """A tiny config's prefill step (8 x 64 tokens into a cache of 72) on
    a (data, model) mesh, or a (pod, data, model) one, of ``shape`` under
    ``specs.default_rules``, the rules of the dry run's cells: its
    argument and temp bytes and its collectives, as :func:`tiny_cell`
    records them."""
    if len(shape) == 2:
        mesh = make_debug_mesh(*shape)
    else:
        mesh = jax.make_mesh(shape, ("pod", "data", "model"),
                             **_mesh_kwargs(3))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    rules = specs.default_rules(mesh)
    cfg = ModelConfig(**fields)
    params = jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0), cfg))
    batch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32)}
    cache = jax.eval_shape(lambda: M.init_cache(cfg, 8, 64 + 8,
                                                jnp.bfloat16))

    def ns(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    cspecs = ns(shd.cache_specs(cache, rules, sizes))
    in_sh = (ns(shd.param_specs(params, rules, sizes)),
             ns(specs.batch_spec_tree(batch, rules, sizes)), cspecs)

    def step(p, b, c):
        with shd.use_rules(rules):
            return M.prefill(p, b, cfg, c)

    module = f"tiny_{name}_step"
    step.__name__ = step.__qualname__ = module
    with jax.set_mesh(mesh):
        compiled = jax.jit(
            step, in_shardings=in_sh,
            out_shardings=(NamedSharding(mesh, P(rules.batch, None)),
                           cspecs),
        ).lower(params, batch, cache).compile()
    mem = compiled.memory_analysis()
    partitioned = _dumped(module)
    return {"argument_bytes": int(mem.argument_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "collectives": hlo_analysis.collective_bytes(partitioned),
            "collective_ops": partitioned_collectives(partitioned)}


def cells():
    mesh = make_production_mesh(multi_pod=False)
    out = {}
    for a in list_archs():
        arch = get_arch(a)
        for s in SHAPES:
            ok, reason = arch.applicable(s)
            rec = {"applicable": [ok, reason]}
            if ok:
                cell = specs.build_cell(arch, s, mesh, analysis_mode=True)
                factor = 6.0 if cell.meta["kind"] == "train" else 2.0
                rec.update(
                    meta=cell.meta,
                    in_specs=flat_specs(cell.in_shardings),
                    out_specs=flat_specs(cell.out_shardings),
                    model_flops=factor * cell.meta["active_params"]
                    * dryrun._tokens(cell.meta))
            out[f"{a}/{s}"] = rec
    return out


def _jsonable(x):
    if isinstance(x, shd.AxisRules):
        return {"AxisRules": dataclasses.asdict(x)}
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if x is jnp.bfloat16:
        return "bfloat16"
    return x


def main():
    try:
        out = {"meshes": meshes(), "tiny": tiny_cell(),
               "tiny_cells": {**{k: tiny_cell(k, v)
                                 for k, v in TINY_CELLS.items()},
                              **{k: tiny_prefill(k, *v)
                                 for k, v in PREFILL_CELLS.items()}},
               "cells": cells(), "hillclimb": _jsonable(perf.HILLCLIMB)}
    finally:
        shutil.rmtree(DUMP, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
