"""The port's dry-run tooling (``repro_torch.launch``: ``mesh``, ``specs``,
``step_analysis``, ``roofline``, ``dryrun``, ``report``, ``perf``) and
``distributed.sharding.named_shardings`` against the JAX package's, on
the CPU.

The reference side runs once, in a subprocess with 512 forced host
devices (``tests/_launch_reference_worker.py``), as
``tests/test_dryrun_small.py`` runs it: the mesh shapes, the tiny train
cell of ``test_dryrun_small.py`` on the 2 x 4 debug mesh (shard shapes,
the compiled ``argument_size_in_bytes`` and the collectives of the
partitioned module; the same for a tiny MoE cell, both implementations,
a tiny SSM cell and a tiny dense cell with 6 heads over TP = 4, and the
tiny dense-MoE cell as a prefill step, also with a pod axis), and every
arch x shape cell
on the 16 x 16 mesh through ``jax.eval_shape`` (``applicable``,
``build_cell``'s meta and sharding specs, the model-FLOPs formula);
nothing of those 40 cells is compiled.  The port side traces on
``meta``, as rank 0 of a partitioned DTensor program over a ``fake``
process group where a cell is partitioned.  Counts compare exactly.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.base import ArchDef
from repro_torch.distributed import sharding as shd
from repro_torch.launch import (
    dryrun, perf, report, roofline, specs, step_analysis,
)
from repro_torch.launch.mesh import (
    make_debug_mesh, make_production_mesh, mesh_axis_sizes,
)
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__),
                      "_launch_reference_worker.py")
CELLS = [(a, s) for a in list_archs() for s in SHAPES]
TINY = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
                   kv_chunk=32)
# test_dryrun_small.py's cell: batch 8 x 64, one microbatch
TINY_OVERRIDES = {"global_batch": 8, "seq_len": 64, "num_microbatches": 1}


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, WORKER], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _flat(tree, path=()):
    """(path, leaf) pairs of a tree, with the reference's key paths."""
    if isinstance(tree, shd.PartitionSpec):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        for f in type(tree)._fields:
            yield from _flat(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _specs(shardings):
    return {p: [list(e) if isinstance(e, tuple) else e for e in ns.spec]
            for p, ns in _flat(shardings)}


def _tiny_arch(cfg=TINY, microbatches=None):
    return ArchDef(name="tiny", full=cfg, smoke=cfg,
                   microbatches=microbatches or {})


def _tiny_cell(cfg=TINY, partitioned=False, **overrides):
    rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                          tp_axis="model",
                          moe_fsdp=cfg.moe_impl != "shard_map")
    return specs.build_cell(_tiny_arch(cfg), "train_4k",
                            make_debug_mesh(2, 4), rules=rules,
                            overrides=dict(TINY_OVERRIDES, **overrides),
                            partitioned=partitioned)


# ---------------------------------------------------------------------------
# meshes and named shardings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["single", "multi", "debug"])
def test_mesh_shapes_match_reference(ref, name):
    mesh = {"single": lambda: make_production_mesh(multi_pod=False),
            "multi": lambda: make_production_mesh(multi_pod=True),
            "debug": lambda: make_debug_mesh(2, 4)}[name]()
    want = ref["meshes"][name]
    assert list(mesh.axis_sizes) == want["shape"]
    assert list(mesh.axis_names) == want["axis_names"]
    assert mesh_axis_sizes(mesh) == want["sizes"]
    assert all(d.type == "meta" for d in mesh.devices)


def test_tiny_cell_shard_shapes_match_reference(ref):
    cell = _tiny_cell()
    got = {}
    for (path, leaf), (_, ns) in zip(_flat(cell.args), _flat(
            cell.in_shardings)):
        got[path] = list(ns.shard_shape(tuple(leaf.shape)))
    assert got == ref["tiny"]["shard_shapes"]


def test_tiny_cell_argument_bytes_match_reference(ref):
    cell = _tiny_cell()
    assert dryrun._shard_bytes(cell.args, cell.in_shardings) == \
        ref["tiny"]["argument_bytes"]


def test_named_sharding_shard_shape_rounds_up():
    mesh = make_debug_mesh(2, 4)
    ns = shd.NamedSharding(mesh, shd.P("model", ("data", "model"), None))
    assert ns.shard_shape((6, 16, 3)) == (2, 2, 3)
    assert shd.NamedSharding(mesh, shd.P()).shard_shape((5, 7)) == (5, 7)


def test_named_shardings_match_reference(ref):
    """As the reference, the specs come without the mesh's sizes: every
    leaf of the tiny cell's params is replicated."""
    params = model_lib.init_params(TINY, None, "meta")
    mesh = make_debug_mesh(2, 4)
    got = shd.named_shardings(params, shd.AxisRules(), mesh)
    assert all(ns.mesh is mesh for _, ns in _flat(got))
    assert _specs(got) == ref["tiny"]["named_shardings"]


# ---------------------------------------------------------------------------
# every cell: applicable, meta and specs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_cells():
    mesh = make_production_mesh(multi_pod=False)
    out = {}
    for a, s in CELLS:
        arch = get_arch(a)
        if arch.applicable(s)[0]:
            out[f"{a}/{s}"] = specs.build_cell(arch, s, mesh)
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_reference(ref, port_cells, arch, shape):
    want = ref["cells"][f"{arch}/{shape}"]
    ok, reason = get_arch(arch).applicable(shape)
    assert [ok, reason] == want["applicable"]
    if not ok:
        return
    cell = port_cells[f"{arch}/{shape}"]
    assert cell.meta == want["meta"]
    assert _specs(cell.in_shardings) == want["in_specs"]
    assert _specs(cell.out_shardings) == want["out_specs"]
    factor = 6.0 if cell.meta["kind"] == "train" else 2.0
    assert factor * cell.meta["active_params"] * dryrun._tokens(
        cell.meta) == want["model_flops"]


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------
FAMILIES = {
    "dense": dataclasses.replace(TINY, num_layers=3),
    "moe": dataclasses.replace(TINY, family="moe", num_layers=3,
                               moe_num_experts=4, moe_top_k=2,
                               moe_d_expert=64),
    "hybrid": dataclasses.replace(TINY, family="hybrid", num_layers=9,
                                  hybrid_attn_every=3, ssm_state=16,
                                  ssm_head_dim=16, ssm_chunk=32),
}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_probes_equal_full_trace(family, shape):
    """3 groups and 3 microbatches: the probes' bilinear solve equals a
    full trace's per-device FLOPs, bytes and collectives exactly (one
    device of the partitioned program on the 2 x 4 mesh)."""
    arch = _tiny_arch(FAMILIES[family], {"train_4k": 3})
    mesh = make_debug_mesh(2, 4)
    ov = {"seq_len": 128 if shape == "decode_32k" else 64,
          "global_batch": 12 if shape == "train_4k" else 4}
    pr = roofline.probe_roofline(arch, shape, mesh, overrides=ov)
    cell = specs.build_cell(arch, shape, mesh, overrides=ov,
                            partitioned=True)
    count = step_analysis.count_step(cell.fn, *cell.args, memory=False)
    coll = roofline.cell_collectives(cell)
    assert pr["est"]["flops"] == count.flops
    assert pr["est"]["bytes"] == count.bytes_accessed
    for k in step_analysis.COLLECTIVES:
        assert pr["est"][f"coll_{k}"] == coll[k]
    assert pr["est"]["coll_count"] == coll["count"] > 0
    assert pr["probes"]["M_probes"] == ([2, 3] if shape == "train_4k"
                                        else [1])


@pytest.mark.parametrize("micro", [1, 8])
def test_tiny_cell_collectives_hand_count(micro):
    """The hand reckoning (``step_analysis.collective_bytes``), each kind
    against a count by hand: tiny cell, 2 x 4 mesh, batch
    8 x 64 over data, remat full, 2 stacked layers, fp32 params, bf16
    compute.  With 8 microbatches a device's share of the batch (4
    sequences) is smaller than the microbatch count: each microbatch
    (one sequence over 2 data shards) is rounded up to one sequence a
    device."""
    coll = roofline.reckoned_collectives(_tiny_cell(num_microbatches=micro))
    bf16, f4, groups = 2, 4, 2
    seqs = 4 if micro == 1 else 1      # a device's sequences of a microbatch
    # all-gather over data in bf16, TP still split: (gathered elements,
    # gathers a microbatch): a stacked leaf in the forward and the
    # recompute, the head once; the embedding table is looked up, not
    # gathered
    stack = [(64 * 16, groups)] * 3 + [   # wq, wk, wv: (64, 64/4)
        (16 * 64, groups),                # wo: (64/4, 64)
        (64 * 32, groups), (64 * 32, groups),   # w_in, w_gate: (64, 128/4)
        (32 * 64, groups)]                # w_out: (128/4, 64)
    head = (64 * 64, 1)                   # lm_head: (64, 256/4)
    assert coll["all-gather"] == micro * bf16 * (
        sum(n * ops * 2 for n, ops in stack) + head[0])
    # gradient reduce-scatters over data, bf16, of the gathered leaves
    assert coll["reduce-scatter"] == micro * bf16 * sum(
        n // 2 * ops for n, ops in stack + [head])
    # all-reduces: the norm scales' fp32 gradients over data (final norm,
    # 2 x 2 stacked), then the bf16 residual over model: per layer wo in
    # the forward and the recompute, w_out in the forward, and the input
    # gradients of wq, wk, wv, w_in and w_gate; the head's input gradient
    norms = 64 * f4 * (1 + 2 * groups)
    residual = seqs * 64 * 64 * bf16
    tp_reduces = (2 + 1 + 5) * groups + 1
    assert coll["all-reduce"] == micro * (norms + residual * tp_reduces)
    assert coll["all-to-all"] == coll["collective-permute"] == 0
    assert coll["count"] == micro * (
        sum(ops * 2 for _, ops in stack) + 1
        + sum(ops for _, ops in stack) + 1
        + 1 + 2 * groups + tp_reduces)


# ---------------------------------------------------------------------------
# the partitioned program's collectives, by group, against XLA's
# ---------------------------------------------------------------------------
TINY_FAMILIES = {
    "dense": TINY,
    "moe_dense": dataclasses.replace(TINY, family="moe", moe_num_experts=4,
                                     moe_top_k=2, moe_d_expert=64),
    "moe_shard_map": dataclasses.replace(TINY, family="moe",
                                         moe_num_experts=4, moe_top_k=2,
                                         moe_d_expert=64,
                                         moe_impl="shard_map"),
    "ssm": dataclasses.replace(TINY, family="ssm", ssm_state=16,
                               ssm_head_dim=16, ssm_chunk=32),
    # 6 heads do not divide over TP = 4
    "uneven_heads": dataclasses.replace(TINY, d_model=96, num_heads=6,
                                        num_kv_heads=6, head_dim=16),
}
# the tiny cells traced as a prefill step (8 x 64 tokens into a cache of
# 72) under the dry run's default rules
TINY_PREFILLS = {"moe_dense_prefill": TINY_FAMILIES["moe_dense"]}


def _tiny_prefill_cell(cfg, shape=(2, 4)):
    """``cfg``'s prefill cell on a (data, model) mesh, or a (pod, data,
    model) one, of ``shape``."""
    from repro_torch.distributed.mesh import DeviceMesh

    mesh = (make_debug_mesh(*shape) if len(shape) == 2 else DeviceMesh(
        (torch.device("meta"),) * math.prod(shape),
        ("pod", "data", "model"), shape))
    return specs.build_cell(_tiny_arch(cfg), "prefill_32k", mesh,
                            overrides={"global_batch": 8, "seq_len": 64},
                            partitioned=True)


# a port collective's group: the first of these functions on its Python
# stack (a collective the backward issues has none of the model's frames
# but ``_ReduceGrad``'s or DTensor's own)
PORT_GROUPS = (
    ("_embed_sharded", "lookup"), ("_vocab_max", "stats"),
    ("_vocab_sumexp", "stats"), ("_vocab_parallel_stats", "stats"),
    ("_global_norm_sharded", "scalars"), ("_replicated", "scalars"),
    ("_as_param", "grad reduction"), ("gather_weight", "weights"),
    ("_moe_dense_partitioned", "moe"), ("_moe_shard_map_partitioned", "moe"),
    ("_scan_partitioned", "ssm"), ("apply_ssm", "ssm"),
    ("backward", "backward"), ("apply_attention", "tp"),
    ("apply_mlp", "tp"), ("constrain", "layout"),
    ("_grads", "scalars"),
)


def _port_groups(cell):
    """(group, kind) -> [count, result bytes] of the collectives one
    device's partitioned program issues, grouped by ``PORT_GROUPS``; the
    backward's are grouped by kind and whether ``_ReduceGrad`` (a
    column-parallel product's input gradient) issued them."""
    import traceback

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    out = {}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            res = func(*args, **(kwargs or {}))
            kind = step_analysis._collective_kind(func)
            if kind and kind != "wait":
                stack = traceback.extract_stack()
                names = {f.name for f in stack}
                group = next(g for f, g in PORT_GROUPS if f in names)
                if group == "backward" and any(
                        "_ReduceGrad" in (f.line or "") or
                        f.name == "backward" and "sharding.py" in f.filename
                        for f in stack):
                    group = "tp"
                row = out.setdefault((group, kind), [0, 0])
                row[0] += 1
                row[1] += step_analysis._nbytes(res)
            return res

    with Mode():
        cell.fn(*cell.args)
    return out


def _xla_groups(ops):
    """(group, kind) -> [count, result bytes] of XLA's collectives, by
    the op that XLA attributes each to (``dot_general``: a product's;
    ``gather``/``scatter-add``: the lookup, the MoE's dispatch; and so
    on), the softmax statistics (f32 of one number per predicted token)
    and the scalars apart."""
    out = {}
    for kind, nbytes, shapes, name, *_ in ops:
        group = name.split("/")[-1] or "(none)"
        if shapes == "f32[4,63]":
            group = "stats"
        elif shapes == "f32[]":
            group = "scalars"
        row = out.setdefault((group, kind), [0, 0])
        row[0] += 1
        row[1] += nbytes
    return out


def _flat_groups(groups):
    return {f"{g}/{k}": v for (g, k), v in sorted(groups.items())}


@pytest.fixture(scope="module")
def port_tiny_groups():
    cells = {name: _tiny_cell(cfg, partitioned=True)
             for name, cfg in TINY_FAMILIES.items()}
    cells.update({name: _tiny_prefill_cell(cfg)
                  for name, cfg in TINY_PREFILLS.items()})
    return {name: _flat_groups(_port_groups(cell))
            for name, cell in cells.items()}


def _ref_tiny(ref, name):
    return ref["tiny"] if name == "dense" else ref["tiny_cells"][name]


def test_counted_collectives_equal_comm_debug_mode():
    """``count_step``'s collectives are the ones ``CommDebugMode`` sees,
    op for op, and every kind counted has bytes."""
    from torch.distributed.tensor.debug import CommDebugMode

    cell = _tiny_cell(partitioned=True)
    with CommDebugMode() as comm:
        count = step_analysis.count_step(cell.fn, *cell.args, memory=False)
    assert count.collectives["count"] == sum(comm.get_comm_counts().values())
    assert count.collectives["count"] == 76
    assert roofline.cell_collectives(_tiny_cell()) == count.collectives


def test_tiny_cell_collectives_match_xla(ref, port_tiny_groups):
    """The dense tiny cell's counted collectives against XLA's module
    after SPMD partitioning (the reference's step for the same cell on
    the same mesh), group by group.  Equal: the FSDP gathers of the
    products' weights (29, bf16), the TP sums of the residual stream (17
    bf16 all-reduces: ``wo`` and ``w_out`` forward and recompute, each
    column-parallel product's input gradient), the three softmax
    statistics (f32 of one number per predicted token), the norm scales'
    gradient sums (the same bytes; XLA sums each group's slice of a
    stacked scale, the port the stacked leaf once).  Named differences:

    - the weight gradients: XLA's CPU partitioner leaves each
      reduce-scatter over data an all-reduce of the whole TP shard
      (twice the bytes on 2 data shards), where the port's program (and
      XLA's GPU pipeline) reduce-scatters;
    - the lookup: XLA gathers the ids over data (the port too, the same
      bytes), sums the rows over model (the same), moves them to the
      batch split by an all-to-all (the same bytes) and mirrors it in
      the backward (the same all-to-all), with collective-permutes of
      the ids and an all-gather, all-reduce and permute of the table's
      gradient rows besides; the port looks up all ids of its d_model
      slice, so the table's gradient is complete on each device;
    - the scalars: XLA's 19 f32 all-reduces (loss, norms of each leaf),
      the port's 5 (the loss, the token count, the gradient norm once
      over each mesh axis).
    """
    xla = _flat_groups(_xla_groups(ref["tiny"]["collective_ops"]))
    port = port_tiny_groups["dense"]
    weights = port["weights/all-gather"]
    assert weights == xla["dot_general/all-gather"] == [29, 90112]
    tp = [o for o in ref["tiny"]["collective_ops"]
          if o[3].endswith("dot_general") and o[2] == "bf16[4,64,64]"]
    # the recompute's two run in the backward
    port_tp = [a + b for a, b in zip(port["tp/all-reduce"],
                                     port["backward/all-reduce"])]
    assert port_tp == [len(tp), sum(o[1] for o in tp)] \
        == [17, 17 * 4 * 64 * 64 * 2]
    assert port["stats/all-reduce"] == xla["stats/all-reduce"] \
        == [3, 3 * 4 * 63 * 4]
    assert port["grad reduction/all-reduce"] == [3, 1280]
    assert xla["reduce_sum/all-reduce"] == [5, 1280]
    # the weight gradients: reduce-scatters, all-reduces of the TP shard
    wgrad = xla["dot_general/all-reduce"][1] - port_tp[1]
    assert port["backward/reduce-scatter"] == [15, 24576]
    assert wgrad == 2 * 24576
    # the lookup
    assert port["lookup/all-gather"] == xla["gather/all-gather"] \
        == [1, 8 * 64 * 4]
    assert port["layout/all-reduce"] == xla["gather/all-reduce"] \
        == [1, 8 * 64 * 32 * 2]
    assert port["layout/all-to-all"] == xla["gather/all-to-all"] \
        == port["backward/all-to-all"] == xla["scatter-add/all-to-all"] \
        == [1, 32768]
    assert xla["gather/collective-permute"] == [1, 4 * 64 * 4]
    assert [xla[f"scatter-add/{k}"] for k in
            ("all-gather", "all-reduce", "collective-permute")] \
        == [[1, 128 * 32 * 2], [1, 128 * 32 * 2], [1, 64 * 32 * 2]]
    assert xla["scalars/all-reduce"] == [19, 76]
    assert port["scalars/all-reduce"] == [5, 20]
    # nothing else on either side
    assert set(port) == {
        "weights/all-gather", "tp/all-reduce", "stats/all-reduce",
        "grad reduction/all-reduce", "backward/reduce-scatter",
        "backward/all-reduce",
        "lookup/all-gather", "layout/all-reduce", "layout/all-to-all",
        "backward/all-to-all", "scalars/all-reduce"}
    assert set(xla) == {
        "dot_general/all-gather", "dot_general/all-reduce",
        "stats/all-reduce", "reduce_sum/all-reduce", "gather/all-gather",
        "gather/all-reduce", "gather/all-to-all", "gather/collective-permute",
        "scatter-add/all-to-all", "scatter-add/all-gather",
        "scatter-add/all-reduce", "scatter-add/collective-permute",
        "scalars/all-reduce"}


def test_tiny_cell_counted_collectives_equal_the_reckoning():
    """On the dense tiny cell the counted collectives equal
    ``step_analysis.collective_bytes``'s reckoning for the groups its
    rules cover: the weights' gathers, the weight gradients'
    reduce-scatters, and the all-reduces of the residual stream and the
    norm scales' gradients; what the rules leave out (the lookup, the
    softmax statistics, the scalars) is counted besides."""
    rules_count = roofline.reckoned_collectives(_tiny_cell())
    coll = roofline.cell_collectives(_tiny_cell())
    lookup = 8 * 64 * 4 + 8 * 64 * 32 * 2 + 2 * 32768
    stats, scalars = 3 * 4 * 63 * 4, 5 * 4
    assert coll["all-gather"] == rules_count["all-gather"] + 8 * 64 * 4
    assert coll["reduce-scatter"] == rules_count["reduce-scatter"]
    assert coll["all-reduce"] == rules_count["all-reduce"] \
        + 8 * 64 * 32 * 2 + stats + scalars
    assert coll["all-to-all"] == 2 * 32768
    assert sum(coll[k] for k in step_analysis.COLLECTIVES) == sum(
        rules_count[k] for k in step_analysis.COLLECTIVES) + lookup \
        + stats + scalars
    # the rules' 96 ops less the 2 norm-scale reductions the port makes
    # once per stacked leaf, plus the lookup's 4, 3 statistics, 5 scalars
    assert coll["count"] == rules_count["count"] - 2 + 4 + 3 + 5


# the other families' collectives by group, XLA's and the port's, pinned:
# (count, result bytes) per (group, kind).  XLA's groups are the ops it
# attributes each collective to; the port's are the functions that issue
# them (see PORT_GROUPS).
PINNED = {'moe_dense': {'port': {'backward/all-gather': [2, 131072],
                        'backward/all-reduce': [10, 401408],
                        'backward/all-to-all': [3, 98304],
                        'backward/reduce-scatter': [9, 12288],
                        'grad reduction/all-reduce': [3, 1280],
                        'layout/all-reduce': [1, 32768],
                        'layout/all-to-all': [1, 32768],
                        'lookup/all-gather': [1, 2048],
                        'moe/all-gather': [4, 262144],
                        'moe/all-reduce': [12, 655360],
                        'moe/all-to-all': [2, 65536],
                        'scalars/all-reduce': [5, 20],
                        'stats/all-reduce': [3, 3024],
                        'tp/all-reduce': [9, 294912],
                        'weights/all-gather': [17, 40960]},
               'xla': {'broadcast_in_dim/all-gather': [8, 8192],
                       'dot_general/all-gather': [17, 40960],
                       'dot_general/all-reduce': [40, 1452032],
                       'gather/all-gather': [7, 395264],
                       'gather/all-reduce': [7, 425984],
                       'gather/all-to-all': [1, 32768],
                       'gather/collective-permute': [9, 336896],
                       'mul/all-gather': [4, 8192],
                       'reduce_sum/all-reduce': [13, 5472],
                       'reduce_window_sum/all-gather': [4, 65536],
                       'scalars/all-reduce': [19, 76],
                       'scatter-add/all-gather': [1, 8192],
                       'scatter-add/all-reduce': [7, 499712],
                       'scatter-add/all-to-all': [7, 294912],
                       'scatter-add/collective-permute': [7, 28672],
                       'stats/all-reduce': [3, 3024],
                       'top_k/all-gather': [4, 32768]}},
 'moe_dense_prefill': {'port': {'layout/all-reduce': [1, 32768],
                                'layout/all-to-all': [1, 32768],
                                'lookup/all-gather': [1, 2048],
                                'moe/all-gather': [2, 131072],
                                'moe/all-reduce': [6, 327680],
                                'moe/all-to-all': [2, 65536],
                                'tp/all-reduce': [2, 65536],
                                'tp/all-to-all': [8, 69632],
                                'weights/all-gather': [9, 24576]},
                       'xla': {'(none)/all-gather': [1, 4096],
                               'broadcast_in_dim/all-gather': [2, 2048],
                               'dot_general/all-gather': [9, 24576],
                               'dot_general/all-reduce': [8, 393216],
                               'dot_general/all-to-all': [12, 49152],
                               'dynamic_update_slice/all-to-all': [4, 32768],
                               'gather/all-gather': [3, 133120],
                               'gather/all-reduce': [3, 163840],
                               'gather/all-to-all': [1, 32768],
                               'gather/collective-permute': [5, 74752],
                               'mul/all-gather': [2, 4096],
                               'reduce_window_sum/all-gather': [2, 32768],
                               'scatter-add/all-reduce': [2, 163840],
                               'scatter-add/all-to-all': [4, 196608],
                               'scatter-add/collective-permute': [2, 8192],
                               'top_k/all-gather': [2, 16384]}},
 'moe_shard_map': {'port': {'backward/all-gather': [4, 81920],
                            'backward/all-reduce': [4, 131072],
                            'backward/all-to-all': [1, 32768],
                            'backward/reduce-scatter': [11, 20480],
                            'grad reduction/all-reduce': [9, 104192],
                            'layout/all-reduce': [1, 32768],
                            'layout/all-to-all': [1, 32768],
                            'lookup/all-gather': [1, 2048],
                            'moe/all-reduce': [6, 65552],
                            'scalars/all-reduce': [5, 20],
                            'stats/all-reduce': [3, 3024],
                            'tp/all-reduce': [9, 294912],
                            'tp/reduce-scatter': [2, 16384],
                            'weights/all-gather': [17, 40960]},
                   'xla': {'dot_general/all-gather': [17, 40960],
                           'dot_general/all-reduce': [20, 385024],
                           'gather/all-gather': [1, 2048],
                           'gather/all-reduce': [1, 32768],
                           'gather/all-to-all': [1, 32768],
                           'gather/collective-permute': [1, 1024],
                           'psum_invariant/all-reduce': [16, 446464],
                           'reduce_sum/all-reduce': [5, 1280],
                           'scalars/all-reduce': [22, 88],
                           'scatter-add/all-gather': [1, 8192],
                           'scatter-add/all-reduce': [1, 8192],
                           'scatter-add/all-to-all': [1, 32768],
                           'scatter-add/collective-permute': [1, 4096],
                           'stats/all-reduce': [3, 3024]}},
 'ssm': {'port': {'backward/all-gather': [24, 277696],
                  'backward/all-reduce': [14, 6336],
                  'backward/all-to-all': [19, 589824],
                  'backward/reduce-scatter': [11, 94592],
                  'grad reduction/all-reduce': [4, 3328],
                  'layout/all-reduce': [1, 32768],
                  'layout/all-to-all': [1, 32768],
                  'lookup/all-gather': [1, 2048],
                  'scalars/all-reduce': [5, 20],
                  'ssm/all-gather': [24, 630784],
                  'ssm/all-reduce': [2, 65536],
                  'ssm/reduce-scatter': [4, 1024],
                  'stats/all-reduce': [3, 3024],
                  'tp/all-reduce': [3, 98304],
                  'weights/all-gather': [9, 62464]},
         'xla': {'(none)/all-gather': [15, 4992],
                 'concatenate/all-to-all': [16, 233472],
                 'dot_general/all-gather': [19, 209920],
                 'dot_general/all-reduce': [20, 461312],
                 'dot_general/all-to-all': [2, 65536],
                 'gather/all-gather': [1, 2048],
                 'gather/all-reduce': [1, 32768],
                 'gather/all-to-all': [1, 32768],
                 'gather/collective-permute': [1, 1024],
                 'reduce_sum/all-reduce': [27, 8016],
                 'scalars/all-reduce': [15, 60],
                 'scatter-add/all-gather': [1, 8192],
                 'scatter-add/all-reduce': [1, 8192],
                 'scatter-add/all-to-all': [1, 32768],
                 'scatter-add/collective-permute': [1, 4096],
                 'split/collective-permute': [60, 454656],
                 'stats/all-reduce': [3, 3024]}},
 'uneven_heads': {'port': {'backward/all-gather': [14, 819200],
                           'backward/all-reduce': [2, 98304],
                           'backward/all-to-all': [1, 49152],
                           'backward/reduce-scatter': [15, 56832],
                           'grad reduction/all-reduce': [3, 1920],
                           'layout/all-reduce': [1, 49152],
                           'layout/all-to-all': [1, 49152],
                           'lookup/all-gather': [1, 2048],
                           'scalars/all-reduce': [5, 20],
                           'stats/all-reduce': [3, 3024],
                           'tp/all-gather': [10, 524288],
                           'tp/all-reduce': [15, 737280],
                           'weights/all-gather': [29, 159744]},
                  'xla': {'dot_general/all-gather': [29, 159744],
                          'dot_general/all-reduce': [32, 921600],
                          'gather/all-gather': [1, 2048],
                          'gather/all-reduce': [1, 49152],
                          'gather/all-to-all': [1, 49152],
                          'gather/collective-permute': [1, 1024],
                          'reduce_sum/all-reduce': [5, 1920],
                          'reshape/all-gather': [14, 344064],
                          'scalars/all-reduce': [19, 76],
                          'scatter-add/all-gather': [1, 12288],
                          'scatter-add/all-reduce': [1, 12288],
                          'scatter-add/all-to-all': [1, 49152],
                          'scatter-add/collective-permute': [1, 6144],
                          'stats/all-reduce': [3, 3024]}}}


@pytest.mark.parametrize("name", ["moe_dense", "moe_dense_prefill",
                                  "moe_shard_map", "ssm", "uneven_heads"])
def test_tiny_family_collectives_against_xla(ref, port_tiny_groups, name):
    """The MoE (both implementations, the dense one also as a prefill
    step), SSM and uneven-heads tiny cells, group by group against XLA's
    partitioned module.  Equal: the softmax statistics, the products'
    weight gathers but the SSM's (the dense MoE's expert weights are not
    gathered on either side: its products contract their d split over
    data; the shard_map MoE's are DP-replicated), and in the dense MoE's
    prefill every product's all-reduce
    (the experts' ``(E, C, ff / TP)`` sums over data and ``(E, C, d /
    2)`` sums over model, the attention's over model).  Every other group
    is a named difference, pinned here with its bytes on both sides: XLA
    moves the dense MoE's dispatch indices, packed tokens and combined
    rows with permutes, all-to-alls and all-reduces, where the port's
    program gathers the tokens once, slices d locally and moves the
    combined rows to the batch split by one all-to-all; XLA moves the
    SSM's fused projection into its parts with collective-permutes and
    all-to-alls, where the port gathers it over TP and scans each
    device's heads; both gather the uneven heads over TP at the reshape
    (XLA 14 all-gathers, the port 10 of more bytes: it gathers q, k and v
    whole and the backward's gradients too); the lookup, the scalars and
    the weight gradients differ as in the dense cell."""
    xla = _flat_groups(_xla_groups(_ref_tiny(ref, name)["collective_ops"]))
    port = port_tiny_groups[name]
    assert port.get("stats/all-reduce") == xla.get("stats/all-reduce")
    if name != "ssm":   # XLA gathers the SSM's fused projection apart
        assert port["weights/all-gather"] == xla["dot_general/all-gather"]
    if name == "moe_dense_prefill":
        assert [a + b for a, b in zip(port["moe/all-reduce"],
                                      port["tp/all-reduce"])] \
            == xla["dot_general/all-reduce"] == [8, 393216]
    if name == "uneven_heads":
        assert port["tp/all-gather"] == [10, 524288]
        assert xla["reshape/all-gather"] == [14, 344064]
    assert port["lookup/all-gather"] == [1, 8 * 64 * 4]
    family = {"ssm": "ssm", "uneven_heads": "tp"}.get(name, "moe")
    assert any(k.startswith(f"{family}/") for k in port)
    want = PINNED[name]
    assert {"xla": xla, "port": port} == want


def _local_blocks(fn, *args):
    """{(shape, dtype)} of every local tensor the partitioned program
    ``fn(*args)`` makes, its backward's included (DTensor-level ops are
    left to their local ops)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    seen = set()

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            res = func(*args, **(kwargs or {}))
            seen.update((tuple(r.shape), r.dtype) for r in tree_leaves(res)
                        if isinstance(r, torch.Tensor))
            return res

    with Mode():
        fn(*args)
    return seen


def _dispatch_blocks(blocks, e, c, tk):
    """The ``(E, C, .)`` slot blocks and the ``(T*k, .)`` row blocks
    among ``blocks``, as ``(shape, bytes)``."""
    def nbytes(shape, dtype):
        return math.prod(shape) * dtype.itemsize
    slots = {(s, nbytes(s, dt)) for s, dt in blocks
             if len(s) == 3 and s[:2] == (e, c)}
    rows = {(s, nbytes(s, dt)) for s, dt in blocks
            if len(s) == 2 and s[0] == tk}
    return slots, rows


def _xla_shapes(ops, prefix):
    """The shapes (results and operands) of XLA's collectives that start
    with ``prefix``, as ``(shape, bytes)``."""
    size = {"bf16": 2, "f32": 4, "s32": 4, "pred": 1}
    out = set()
    for _, _, result, _, operands in ops:
        for t in (result + " " + operands).split():
            dtype, dims = t[:-1].split("[")
            shape = tuple(int(x) for x in dims.split(",") if x)
            if shape[:len(prefix)] == prefix:
                out.add((shape, math.prod(shape) * size[dtype]))
    return out


# the dense MoE's tiny cells: (mesh shape, the (E, C, .) shapes XLA moves,
# the width of the port's token rows: d over data)
DISPATCH_CELLS = {
    "moe_dense": ((2, 4), {(4, 320, 32), (4, 320, 16)}, 32),
    "moe_dense_prefill": ((2, 4), {(4, 320, 32), (4, 320, 16)}, 32),
    "moe_dense_pod_prefill": ((2, 4, 1), {(4, 320, 16), (4, 320, 64)}, 16),
}


@pytest.mark.parametrize("name", list(DISPATCH_CELLS))
def test_dense_moe_dispatch_blocks_match_xla(ref, name):
    """The tiny dense-MoE cell (E = 4, T = 512 tokens, k = 2, C = 320) on
    the 2 x 4 mesh, as the train step and as the prefill step, and as the
    prefill step on a 2 x 4 x 1 (pod x data x model) mesh: the port's
    partitioned program holds its capacity slots, expert outputs and
    hidden slots in the ``(E, C, .)`` shapes XLA's module moves (d split
    over data, the axis that splits the expert weights' d, not over pod;
    ff over model), the same largest ``(E, C, .)`` block, its token rows
    as ``(T*k, d / data)``, and no ``(T*k, .)`` block larger than XLA's
    largest (on the pod mesh XLA gathers the rows whole)."""
    shape, want_slots, width = DISPATCH_CELLS[name]
    cfg = TINY_FAMILIES["moe_dense"]
    cell = (_tiny_cell(cfg, partitioned=True) if name == "moe_dense"
            else _tiny_prefill_cell(cfg, shape))
    e, tk, c = 4, 512 * 2, 320
    slots, rows = _dispatch_blocks(_local_blocks(cell.fn, *cell.args), e, c,
                                   tk)
    ops = _ref_tiny(ref, name)["collective_ops"]
    xla_slots, xla_rows = _xla_shapes(ops, (e, c)), _xla_shapes(ops, (tk,))
    assert {s for s, _ in slots} == {s for s, _ in xla_slots} == want_slots
    assert max(b for _, b in slots) == max(b for _, b in xla_slots)
    assert ((tk, width), tk * width * 2) in rows
    assert max(b for _, b in rows) <= max(b for _, b in xla_rows)


def test_partitioned_dense_moe_blocks_shrink_with_the_data_axis():
    """``apply_moe_dense`` alone on a 2 x 1 and a 4 x 1 (data x model)
    mesh at one global batch (8 x 64 tokens, d = 64, 4 experts, top 2,
    fp32): its largest ``(E, C, .)`` and ``(T*k, .)`` blocks halve from
    data = 2 to data = 4, as its d split halves.  The experts are 16
    wide, so that the hidden ``(E, C, ff)`` slots, which no data split
    divides (on XLA's side neither), stay below the d slices."""
    from repro_torch.launch.mesh import fake_dtensor_mesh
    from repro_torch.models import moe

    spec = moe.MoESpec(d_model=64, d_expert=16, num_experts=4, top_k=2)
    rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                          tp_axis="model")
    layout = {"router": ((64, 4), shd.P(None, None)),
              "w_in": ((4, 64, 16), shd.P(None, "data", "model")),
              "w_gate": ((4, 64, 16), shd.P(None, "data", "model")),
              "w_out": ((4, 16, 64), shd.P(None, "model", "data"))}
    largest = {}
    for n in (2, 4):
        mesh = make_debug_mesh(n, 1)
        dmesh = fake_dtensor_mesh(mesh)
        params = {k: shd.place(torch.empty(shape, device="meta"),
                               shd.NamedSharding(mesh, p), dmesh)
                  for k, (shape, p) in layout.items()}
        x = shd.place(torch.empty(8, 64, 64, device="meta"),
                      shd.NamedSharding(mesh, shd.P("data", None, None)),
                      dmesh)
        with shd.use_rules(rules), shd.use_dtensor_mesh(dmesh):
            blocks = _local_blocks(moe.apply_moe_dense, params, x, spec)
        slots, rows = _dispatch_blocks(blocks, 4, spec.capacity(512), 1024)
        assert ((4, 320, 16), 4 * 320 * 16 * 4) in slots   # the hidden
        largest[n] = (max(b for _, b in slots), max(b for _, b in rows))
    assert largest[2] == (4 * 320 * 32 * 4, 1024 * 32 * 4)
    assert largest[4] == (largest[2][0] // 2, largest[2][1] // 2)


def test_single_device_mesh_has_no_collectives():
    rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                          tp_axis="model")
    cell = specs.build_cell(_tiny_arch(), "train_4k", make_debug_mesh(1, 1),
                            rules=rules, overrides=dict(TINY_OVERRIDES))
    assert all(v == 0 for v in roofline.cell_collectives(cell).values())
    assert all(v == 0 for v in roofline.reckoned_collectives(cell).values())


def test_tiny_cell_flops_per_device_by_hand():
    """One device's FLOPs of the partitioned tiny cell, by hand: 4 of the
    8 sequences (data) of 64 tokens, one of 4 heads, a quarter of d_ff
    and of the vocab (model); each product once, not once as a DTensor
    op and again as its local op."""
    tokens, d, hd, ff_l, vocab_l, layers = 4 * 64, 64, 16, 32, 64, 2
    qkv_o = 4 * 2 * tokens * d * hd                 # wq, wk, wv, wo
    mlp = 3 * 2 * tokens * d * ff_l                 # w_in, w_gate, w_out
    attn = 2 * 2 * (4 * 64) * 32 * hd * 2           # q.k, p.v; 2 chunks
    head = 2 * tokens * d * vocab_l
    fwd = layers * (qkv_o + mlp + attn) + head
    # the backward twice the forward; the recompute re-runs each layer
    # but its last product (w_out), whose output only feeds the residual
    recompute = layers * (qkv_o + mlp + attn - 2 * tokens * ff_l * d)
    count = step_analysis.count_step(
        *(lambda c: (c.fn, *c.args))(_tiny_cell(partitioned=True)),
        memory=False)
    assert count.flops == 3 * fwd + recompute == 54525952
    whole = step_analysis.count_step(
        *(lambda c: (c.fn, *c.args))(_tiny_cell()), memory=False)
    assert whole.flops == 8 * count.flops


def test_count_step_is_the_same_twice_in_a_fresh_process():
    """The first count of a partitioned cell in a process equals the
    second: DTensor plans each op and layout once and caches the plan,
    and its planning ops stay out of every count (run in a fresh
    interpreter, so that no count before it has filled the caches)."""
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1])\n"
        "import test_torch_launch as t\n"
        "from repro_torch.launch import step_analysis\n"
        "out = {}\n"
        "for name, cfg in t.TINY_FAMILIES.items():\n"
        "    c = [step_analysis.count_step(cell.fn, *cell.args) for cell in\n"
        "         (t._tiny_cell(cfg, partitioned=True) for _ in range(2))]\n"
        "    out[name] = [list(x[:3]) + [x.collectives] for x in c]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code,
                          os.path.dirname(__file__)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    counts = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(counts) == set(TINY_FAMILIES)
    for name, (first, second) in counts.items():
        assert first == second, name
        assert first[2] > 0, name              # a temp peak was tracked


def test_count_step_raises_without_dtensor_planners(monkeypatch):
    """A torch whose DTensor has none of the planning functions that
    ``count_step`` keeps out of its counts makes it raise, not count
    them."""
    monkeypatch.setitem(step_analysis._PLANNERS, "redistribute",
                        ("_no_such_planner",))
    cell = _tiny_cell(partitioned=True)
    with pytest.raises(RuntimeError, match="planning ops"):
        step_analysis.count_step(cell.fn, *cell.args, memory=False)


@pytest.mark.parametrize("name", list(TINY_FAMILIES))
def test_tiny_cell_partitioned_memory(ref, name):
    """Each tiny cell's ``argument_bytes`` per device equals XLA's
    ``argument_size_in_bytes``, and the partitioned program's temp peak
    is at most the unpartitioned trace's at one data shard's batch (the
    upper bound the dry run recorded before it traced a device's own
    program)."""
    cfg = TINY_FAMILIES[name]
    cell = _tiny_cell(cfg, partitioned=True)
    assert dryrun._shard_bytes(_tiny_cell(cfg).args, cell.in_shardings) \
        == _ref_tiny(ref, name)["argument_bytes"]
    part = step_analysis.count_step(cell.fn, *cell.args).temp_peak_bytes
    shard = specs.build_cell(
        _tiny_arch(cfg), "train_4k", make_debug_mesh(1, 4),
        rules=cell.rules, overrides=dict(TINY_OVERRIDES, global_batch=4))
    bound = step_analysis.count_step(shard.fn, *shard.args).temp_peak_bytes
    assert 0 < part <= bound


def test_placements_and_place():
    """A spec's placements (a dimension over two axes is ``Shard`` on
    each), and ``place``'s local blocks, an uneven split rounded up on
    rank 0 as ``NamedSharding.shard_shape`` gives it."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import fake_dtensor_mesh

    dmesh = fake_dtensor_mesh(make_debug_mesh(2, 4))
    assert shd.placements(shd.P("model", None), dmesh) == (Replicate(),
                                                           Shard(0))
    pod = fake_dtensor_mesh(make_production_mesh(multi_pod=True))
    assert pod.mesh.shape == (2, 16, 16)
    assert shd.placements(shd.P(("pod", "data"), "model"), pod) == (
        Shard(0), Shard(0), Shard(1))
    mesh = make_debug_mesh(2, 4)
    ns = shd.NamedSharding(mesh, shd.P("model", "data"))
    t = torch.empty(10, 6, device="meta", requires_grad=True)
    placed = shd.place({"w": t}, {"w": ns}, dmesh)["w"]
    assert tuple(placed.shape) == (10, 6)
    assert tuple(placed.to_local().shape) == ns.shard_shape((10, 6)) \
        == (3, 3)
    assert placed.is_leaf and placed.requires_grad


def test_constrain_redistributes_under_a_dtensor_mesh():
    """Without a DTensor mesh ``constrain`` returns its input; under one
    it redistributes a DTensor to the resolved spec, as
    ``with_sharding_constraint`` does."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import fake_dtensor_mesh

    dmesh = fake_dtensor_mesh(make_debug_mesh(2, 4))
    mesh = make_debug_mesh(2, 4)
    x = shd.place(torch.empty(8, 16, 32, device="meta"),
                  shd.NamedSharding(mesh, shd.P("data", None, "model")),
                  dmesh)
    rules = shd.AxisRules()
    with shd.use_rules(rules):
        assert shd.constrain(x, "batch", None, None) is x
        with shd.use_dtensor_mesh(dmesh), CommDebugMode() as comm:
            y = shd.constrain(x, "batch", None, None)
    assert y.placements == (Shard(0), Replicate())
    assert tuple(y.to_local().shape) == (4, 16, 32)
    assert sum(comm.get_comm_counts().values()) == 1


def test_count_step_memory_and_flops_by_hand():
    """A known program: two (64, 128) @ (128, 32) products, one kept."""
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta")

    def fn(a, b):
        c = a @ b            # 8 KB, alive until fn returns
        return (c @ b.t()) + 1   # a 32 KB product, then a 32 KB sum

    count = step_analysis.count_step(fn, a, b)
    assert count.flops == 2 * 64 * 128 * 32 * 2
    # peak: c (8 KB) + the product (32 KB) + the sum (32 KB)
    assert count.temp_peak_bytes == 64 * 32 * 4 + 2 * 64 * 128 * 4
    # each product reads both operands and writes its output (b.t() is a
    # view); the sum reads the product and writes its own (the Python
    # scalar is no tensor)
    mm = (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert count.bytes_accessed == 2 * mm + 2 * 64 * 128 * 4


def test_run_cell_records_model_flops(tmp_path, monkeypatch):
    arch = _tiny_arch(FAMILIES["dense"], {"train_4k": 2})
    monkeypatch.setattr(dryrun, "get_arch", lambda name: arch)
    rec = dryrun.run_cell("tiny", "train_4k", False, str(tmp_path),
                          overrides={"seq_len": 64, "global_batch": 8},
                          mesh=make_debug_mesh(2, 4))
    assert rec["status"] == "ok", rec.get("traceback")
    meta = rec["meta"]
    assert rec["model_flops_total"] == 6.0 * meta["active_params"] \
        * meta["seq_len"] * meta["global_batch"]
    assert rec["useful_flops_ratio"] == rec["model_flops_total"] \
        / rec["traced_flops_total"]
    assert rec["traced_flops_total"] == rec["cost"]["flops_per_device"] * 8
    assert rec["memory"]["temp_bound"] == "device"
    assert rec["partitioned"] is True and rec["traced_microbatches"] == 2
    # the step's collectives, counted (the probes' solve)
    sched = rec["collective_schedule"]
    assert sched["count"] == round(rec["collectives"]["count"]) > 0
    assert all(sched[k] == round(rec["collectives"][k])
               for k in step_analysis.COLLECTIVES)
    assert rec["mesh"] == "mesh2x4"
    saved = json.load(open(tmp_path / "tiny__train_4k__mesh2x4.json"))
    assert saved["status"] == "ok"


# ---------------------------------------------------------------------------
# report and perf
# ---------------------------------------------------------------------------
def _records():
    ok = {"arch": "a", "shape": "train_4k", "mesh": "pod16x16",
          "status": "ok", "meta": {"mesh": "16x16"},
          "memory": {"total_per_device_gb": 3.5, "fits": True},
          "t": 12.5, "coll": {"all-reduce": 10, "all-gather": 0, "count": 2},
          "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                       "collective_s": 0.5, "dominant": "memory",
                       "bound_s": 2.0},
          "model_flops_total": 1e18, "useful_flops_ratio": 0.8}
    multi = dict(ok, mesh="pod2x16x16", meta={"mesh": "2x16x16"})
    skip = {"arch": "b", "shape": "long_500k", "mesh": "pod16x16",
            "status": "skip", "reason": "quadratic"}
    err = {"arch": "c", "shape": "decode_32k", "mesh": "pod16x16",
           "status": "error", "error": "ValueError: x"}
    return [ok, multi, skip, err]


def _as(recs, pkg):
    """The records in one package's keys."""
    keys = ({"fits": "fits_16gb_hbm", "t": "t_compile_s",
             "coll": "collective_schedule_scanned_hlo"} if pkg == "repro"
            else {"fits": "fits_80gb_hbm", "t": "t_trace_s",
                  "coll": "collective_schedule"})
    out = []
    for r in recs:
        r = json.loads(json.dumps(r))
        if "memory" in r:
            r["memory"][keys["fits"]] = r["memory"].pop("fits")
            r[keys["t"]] = r.pop("t")
            r[keys["coll"]] = r.pop("coll")
        out.append(r)
    return out


def test_report_tables_match_reference():
    from repro.launch import report as ref_report

    ref_recs, recs = _as(_records(), "repro"), _as(_records(), "repro_torch")
    swap = [("fits 16GB", "fits 80 GB"), ("| compile |", "| trace |"),
            ("collectives (scanned HLO)", "collectives (counted)"),
            ("cells compiled OK", "cells traced OK"),
            ("fit 16 GB HBM/device",
             "fit 80 GB HBM/device at their device's own peak"),
            ("MODEL/HLO flops", "MODEL/traced flops")]
    want = ref_report.dryrun_table(ref_recs) + "\n" + ref_report.summary(
        ref_recs)
    for a, b in swap:
        want = want.replace(a, b)
    assert report.dryrun_table(recs) + "\n" + report.summary(recs) == want
    # the roofline table, the MFU column at the H100's peak
    scale = ref_report.PEAK / step_analysis.PEAK_FLOPS_BF16
    for r, q in zip(recs, ref_recs):
        if r["status"] == "ok":
            assert report.mfu_at_bound(r) == pytest.approx(
                ref_report.mfu_at_bound(q) * scale, rel=1e-12)
    got_rows = report.roofline_table(recs).splitlines()
    want_rows = ref_report.roofline_table(ref_recs).splitlines()
    assert len(got_rows) == len(want_rows) == 3
    drop = lambda row: row.split("|")[:7] + row.split("|")[8:]  # noqa: E731
    assert drop(got_rows[2]) == drop(want_rows[2])
    assert report.PEAK == step_analysis.PEAK_FLOPS_BF16 == 989.4e12


def test_h100_constants():
    from repro_torch.core.cost_model import H100_HBM_BYTES_PER_S

    assert step_analysis.HBM_BW == H100_HBM_BYTES_PER_S == 3.35e12
    assert step_analysis.LINK_BW == 50e9
    assert step_analysis.HBM_BYTES == 81559 * 2**20
    t = step_analysis.roofline_terms(989.4e12, 3.35e12 * 2, 50e9 * 3)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 3.0)
    assert t.dominant == "collective" and t.bound_s == 3.0
    assert t.roofline_fraction() == pytest.approx(1 / 3)


def _port_jsonable(x):
    if isinstance(x, shd.AxisRules):
        return {"AxisRules": dataclasses.asdict(x)}
    if isinstance(x, dict):
        return {k: _port_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_port_jsonable(v) for v in x]
    if x is torch.bfloat16:
        return "bfloat16"
    return x


def test_perf_hillclimb_matches_reference(ref):
    got = json.loads(json.dumps(_port_jsonable(perf.HILLCLIMB)))
    assert got == ref["hillclimb"]


# ---------------------------------------------------------------------------
# every arch's full config on meta
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_archs())
def test_full_config_forward_traces_on_meta(arch):
    cfg = get_arch(arch).full
    seq = (cfg.num_patches + 32) if cfg.frontend == "vision" else 64
    params = model_lib.init_params(cfg, None, "meta")
    batch = specs.batch_structs(cfg, 1, seq)
    with torch.no_grad():
        logits, aux = model_lib.forward(params, batch, cfg)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (1, seq, cfg.padded_vocab)
    assert logits.dtype == torch.float32 and aux.shape == ()
