"""The port's dry-run tooling (``repro_torch.launch``: ``mesh``, ``specs``,
``step_analysis``, ``roofline``, ``dryrun``, ``report``, ``perf``) and
``distributed.sharding.named_shardings`` against the JAX package's, on
the CPU.

The reference side runs once, in a subprocess with 512 forced host
devices (``tests/_launch_reference_worker.py``), as
``tests/test_dryrun_small.py`` runs it: the mesh shapes, the tiny train
cell of ``test_dryrun_small.py`` on the 2 x 4 debug mesh (shard shapes,
the compiled ``argument_size_in_bytes`` and the collectives of the
partitioned module), and every arch x shape cell
on the 16 x 16 mesh through ``jax.eval_shape`` (``applicable``,
``build_cell``'s meta and sharding specs, the model-FLOPs formula);
nothing of those 40 cells is compiled.  The port side traces on
``meta``.  Counts compare exactly.
"""
import dataclasses
import json
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


def _tiny_cell(**overrides):
    rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                          tp_axis="model")
    return specs.build_cell(_tiny_arch(), "train_4k", make_debug_mesh(2, 4),
                            rules=rules,
                            overrides=dict(TINY_OVERRIDES, **overrides))


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
    full trace's FLOPs, bytes and collectives exactly."""
    arch = _tiny_arch(FAMILIES[family], {"train_4k": 3})
    mesh = make_debug_mesh(2, 4)
    ov = {"seq_len": 128 if shape == "decode_32k" else 64,
          "global_batch": 12 if shape == "train_4k" else 4}
    pr = roofline.probe_roofline(arch, shape, mesh, overrides=ov)
    cell = specs.build_cell(arch, shape, mesh, overrides=ov)
    count = step_analysis.count_step(cell.fn, *cell.args, memory=False)
    coll = roofline.cell_collectives(cell)
    assert pr["est"]["flops"] * 8 == count.flops
    assert pr["est"]["bytes"] * 8 == count.bytes_accessed
    for k in step_analysis.COLLECTIVES:
        assert pr["est"][f"coll_{k}"] == coll[k]
    assert pr["est"]["coll_count"] == coll["count"]
    assert pr["probes"]["M_probes"] == ([2, 3] if shape == "train_4k"
                                        else [1])


@pytest.mark.parametrize("micro", [1, 8])
def test_tiny_cell_collectives_hand_count(micro):
    """Each kind against a count by hand: tiny cell, 2 x 4 mesh, batch
    8 x 64 over data, remat full, 2 stacked layers, fp32 params, bf16
    compute.  With 8 microbatches a device's share of the batch (4
    sequences) is smaller than the microbatch count: each microbatch
    (one sequence over 2 data shards) is rounded up to one sequence a
    device."""
    coll = roofline.cell_collectives(_tiny_cell(num_microbatches=micro))
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


# the embedding lookup and its gradient's scatter-add, as XLA partitions
# them for the tiny cell (the rules leave them out): the token ids
# permuted and gathered over data, the looked-up rows all-reduced over
# the vocab's model axis and moved back to the batch split by an
# all-to-all; the scatter-add's mirror, whose data all-reduce of the
# table's gradient rows stands for the table's gradient reduction
TINY_LOOKUP = sorted([
    ["collective-permute", "s32[4,64,1]"], ["all-gather", "s32[8,64,1]"],
    ["all-reduce", "bf16[8,64,32]"], ["all-to-all", "bf16[2,4,64,32]"],
    ["all-gather", "bf16[128,32]"], ["all-to-all", "bf16[4,64,2,32]"],
    ["all-reduce", "bf16[128,32]"], ["collective-permute", "bf16[64,32]"],
])


def test_tiny_cell_collectives_match_xla(ref):
    """The tiny cell's reckoned collectives against XLA's: the
    reference's step for the same cell on the same mesh, after SPMD
    partitioning, summed by the reference's
    ``hlo_analysis.collective_bytes``.  XLA's ops fall in four groups:

    - the embedding lookup and its gradient (ops from ``gather`` and
      ``scatter-add``), which the rules leave out: ``TINY_LOOKUP``;
    - the vocab-parallel softmax's statistics, left out: three fp32
      all-reduces over model of one number per predicted token (4 x 63 a
      device);
    - scalar all-reduces (the loss, the gradient norm), left out;
    - the rest, which the rules reckon.  Kind by kind it equals the
      port's exactly, but for one difference: XLA's CPU partitioner
      leaves each gradient's reduce-scatter over data as an all-reduce of
      the whole TP shard (twice the shard on 2 data shards) and a slice,
      where the GPU pipeline forms the reduce-scatter the rules count.
    """
    xla, ops = ref["tiny"]["collectives"], ref["tiny"]["collective_ops"]
    coll = roofline.cell_collectives(_tiny_cell())
    for k in step_analysis.COLLECTIVES:
        assert sum(b for kind, b, _, _ in ops if kind == k) == xla[k]
    assert len(ops) == xla["count"]

    lookup = [o for o in ops if o[3].endswith(("/gather", "/scatter-add"))]
    stats = [o for o in ops if o[2] == "f32[4,63]"]
    scalars = [o for o in ops if o[2] == "f32[]"]
    assert sorted([kind, shapes] for kind, _, shapes, _ in lookup) \
        == TINY_LOOKUP
    assert [o[0] for o in stats] == ["all-reduce"] * 3
    assert sum(o[1] for o in stats) == 3 * 4 * 63 * 4
    assert {o[0] for o in scalars} == {"all-reduce"}
    assert all(o[1] == 4 for o in scalars)

    rest = [o for o in ops if not (o in lookup or o in stats or o in scalars)]
    assert len(rest) == len(ops) - len(lookup) - len(stats) - len(scalars)
    got = {k: sum(b for kind, b, _, _ in rest if kind == k)
           for k in step_analysis.COLLECTIVES}
    n_data = 2
    assert got["all-gather"] == coll["all-gather"]
    assert got["reduce-scatter"] == 0
    assert got["all-reduce"] == coll["all-reduce"] \
        + n_data * coll["reduce-scatter"]
    assert got["all-to-all"] == coll["all-to-all"] == 0
    assert got["collective-permute"] == coll["collective-permute"] == 0
    assert len(rest) == coll["count"]


def test_single_device_mesh_has_no_collectives():
    rules = shd.AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                          tp_axis="model")
    cell = specs.build_cell(_tiny_arch(), "train_4k", make_debug_mesh(1, 1),
                            rules=rules, overrides=dict(TINY_OVERRIDES))
    coll = roofline.cell_collectives(cell)
    assert all(v == 0 for v in coll.values())


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
    assert rec["memory"]["temp_bound"] == "upper"
    assert rec["partitioned"] is False and rec["traced_microbatches"] == 2
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
            ("collectives (scanned HLO)", "collectives (reckoned)"),
            ("cells compiled OK", "cells traced OK"),
            ("fit 16 GB HBM/device", "fit 80 GB HBM/device at the upper bound"),
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
