"""repro_torch ``prepare`` against ``repro.core.spmm.prepare``, leaf for leaf.

The same COO (made with numpy from a seed) and the same config go through
both packages; every one of the 19 plan leaves must be exactly equal, in
value and dtype, and so must the tier, the format, the stats (timings
aside), the update maps and the signature (impl aside).  ``prepare`` runs
no kernel, so the port's ``impl="torch"`` plans are compared with the
reference's ``impl="xla"`` ones, and the k-bucketed stream, which the port
builds for ``impl="cuda"`` only, with the reference's ``impl="pallas"``.
"""
import dataclasses

import numpy as np
import pytest

# held against the JAX package: skip where it is not installed (the
# card's machine need not have it; tests/test_torch_gpu.py runs there)
pytest.importorskip("jax")

from repro.core import cost_model as jax_cost_model  # noqa: E402
from repro.core import formats as jax_formats  # noqa: E402
from repro.core import plan_ir as jax_plan_ir  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.data import graphs  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.core import cost_model, formats, plan_ir, spmm  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.errors import PlanBuildError  # noqa: E402
from conftest import make_sparse  # noqa: E402

_TIMINGS = ("t_partition_s", "t_reorder_s", "t_pack_s")
_MAP_FIELDS = ("rows", "cols", "vals", "path", "core_lin", "fringe_pos",
               "kb_pos", "core_lin_sorted", "core_members_sorted",
               "key_sorted", "key_order")


def _spec(name, max_dim=None):
    spec = graphs.PAPER_DATASETS[name]
    if max_dim:
        spec = dataclasses.replace(spec, m=min(spec.m, max_dim),
                                   k=min(spec.k, max_dim))
    rows, cols, vals = graphs.generate(spec)
    return rows, cols, vals, (spec.m, spec.k)


def _jax_leaves(plan):
    leaves, _ = plan.tree_flatten()
    return {name: np.asarray(x) for name, x in zip(LEAF_NAMES, leaves)}


def _assert_same_leaves(ours, theirs, skip=()):
    for name in LEAF_NAMES:
        if name in skip:
            continue
        a, b = ours[name], theirs[name]
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.array_equal(a, b), name


def _assert_same_meta(ours_meta, theirs, skip=()):
    assert ours_meta["shape"] == theirs.shape
    for key in ("fringe_tier", "fringe_bk", "matrix_format", "format_params"):
        if key not in skip:
            assert ours_meta[key] == getattr(theirs, key), key
    ours_stats = {k: v for k, v in ours_meta["stats"] if k not in _TIMINGS}
    theirs_stats = {k: v for k, v in theirs.stats if k not in _TIMINGS}
    for key in skip:
        ours_stats.pop(key, None)
        theirs_stats.pop(key, None)
    assert ours_stats == theirs_stats
    om, tm = ours_meta["update_maps"], theirs.update_maps
    for f in _MAP_FIELDS:
        assert np.array_equal(getattr(om, f), getattr(tm, f)), f


def _both(rows, cols, vals, shape, **cfg):
    """(port plan on the CPU, its leaves/meta, reference plan)."""
    ours = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="torch", **cfg))
    theirs = jax_spmm.prepare(rows, cols, vals, shape,
                              jax_spmm.SpmmConfig(impl="xla", **cfg))
    return ours, theirs


def _plan_meta(plan):
    return dict(shape=plan.shape, stats=plan.stats,
                fringe_tier=plan.fringe_tier, fringe_bk=plan.fringe_bk,
                matrix_format=plan.matrix_format,
                format_params=plan.format_params,
                update_maps=plan.update_maps)


def _check(ours, theirs):
    leaves = {n: t.numpy() for n, t in ours.leaves().items()}
    _assert_same_leaves(leaves, _jax_leaves(theirs))
    _assert_same_meta(_plan_meta(ours), theirs)
    sig, ref_sig = ours.signature(), theirs.signature()
    assert sig[:5] + sig[6:] == ref_sig[:5] + ref_sig[6:]


@pytest.mark.parametrize("name,max_dim", [
    ("cora", None),
    ("ogbn-arxiv", None),   # the ksharded tier by default
    ("dlmc-unstr", None),
    ("F1", 8192),           # the banded generator, scaled to 8,192 rows
])
def test_leaves_match_reference_on_panel(name, max_dim):
    rows, cols, vals, shape = _spec(name, max_dim)
    ours, theirs = _both(rows, cols, vals, shape)
    _check(ours, theirs)
    assert ours.device.type == "cpu"
    if name == "ogbn-arxiv":
        assert ours.fringe_tier == "ksharded" and ours.fringe_bk == 2048


@pytest.mark.parametrize("cfg", [
    dict(alpha=1.0),                              # all fringe
    dict(alpha=1e-9, enable_col_stage=False),     # all core
    dict(reorder_cols=True),
    dict(bm=64, bk=32, bn=128, fringe_chunk=16),
    dict(enable_reuse_order=False, enable_global_reorder=False),
])
def test_leaves_match_reference_across_configs(cfg):
    rng = np.random.RandomState(7)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.05, n_dense_rows=12)
    ours, theirs = _both(rows, cols, vals, (300, 260), **cfg)
    _check(ours, theirs)
    if cfg.get("alpha") == 1.0:
        assert not ours.has_core and ours.has_fringe
    if cfg.get("alpha") == 1e-9:
        assert ours.has_core and not ours.has_fringe


def test_empty_matrix_leaves_match_reference():
    empty = np.zeros(0, np.int64)
    ours, theirs = _both(empty, empty, np.zeros(0, np.float32), (32, 48))
    _check(ours, theirs)
    assert not ours.has_core and not ours.has_fringe


def test_duplicates_and_f64_values_match_reference():
    rng = np.random.RandomState(1)
    rows = rng.randint(0, 90, 1500)
    cols = rng.randint(0, 70, 1500)
    vals = rng.randn(1500)  # float64 with repeated (row, col) pairs
    ours, theirs = _both(rows, cols, vals, (90, 70))
    _check(ours, theirs)


# budgets for k=96, ~60 packed rows, bn=128 (as in test_fused_executor):
# huge -> resident; 60 kB fits only a k-slice -> ksharded; 4 kB -> xla
@pytest.mark.parametrize("budget,tier", [
    (None, "resident"), (60_000, "ksharded"), (4_096, "xla"),
])
def test_each_tier_forced_by_budget_matches_reference(budget, tier):
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 60, 400)
    cols = rng.randint(0, 96, 400)
    vals = rng.randn(400).astype(np.float32)
    cfg = dict(bn=128, alpha=1.0, fringe_vmem_budget=budget)
    ours, theirs = _both(rows, cols, vals, (60, 96), **cfg)
    _check(ours, theirs)
    assert ours.fringe_tier == tier
    # the k-bucketed stream, which the streaming kernel reads
    leaves, meta = spmm.build_plan_arrays(
        rows, cols, vals, (60, 96), SpmmConfig(impl="cuda", **cfg))
    pallas = jax_spmm.prepare(rows, cols, vals, (60, 96),
                              jax_spmm.SpmmConfig(impl="pallas", **cfg))
    skip = ("fringe_tier", "fringe_bk") if tier == "xla" else ()
    _assert_same_leaves(leaves, _jax_leaves(pallas))
    _assert_same_meta(meta, pallas, skip=skip)
    if tier == "ksharded":
        assert leaves["fringe_kb_rows"].size >= leaves["fringe_rows"].size


def test_arxiv_kbucketed_stream_matches_reference():
    # the reference's split (its cost model, passed explicitly): under the
    # card's own split, which impl="cuda" resolves, the leaves differ
    rows, cols, vals, shape = _spec("ogbn-arxiv")
    leaves, meta = spmm.build_plan_arrays(
        rows, cols, vals, shape, SpmmConfig(impl="cuda"),
        cost_model=cost_model.default_cost_model())
    theirs = jax_spmm.prepare(rows, cols, vals, shape,
                              jax_spmm.SpmmConfig(impl="pallas"))
    assert meta["fringe_tier"] == "ksharded"
    _assert_same_leaves(leaves, _jax_leaves(theirs))
    _assert_same_meta(meta, theirs)


def test_h100_tier_rule_changes_only_the_tier():
    """Where the reference's arithmetic says "xla", impl="cuda" runs the
    row-walk kernel ("resident"); every leaf still matches."""
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 60, 400)
    cols = rng.randint(0, 96, 400)
    vals = rng.randn(400).astype(np.float32)
    cfg = dict(bn=128, alpha=1.0, fringe_vmem_budget=4_096)
    leaves, meta = spmm.build_plan_arrays(
        rows, cols, vals, (60, 96), SpmmConfig(impl="cuda", **cfg))
    theirs = jax_spmm.prepare(rows, cols, vals, (60, 96),
                              jax_spmm.SpmmConfig(impl="xla", **cfg))
    assert theirs.fringe_tier == "xla"
    assert (meta["fringe_tier"], meta["fringe_bk"]) == ("resident", 0)
    assert dict(meta["stats"])["fringe_tier"] == "resident"
    _assert_same_leaves(leaves, _jax_leaves(theirs))
    _assert_same_meta(meta, theirs, skip=("fringe_tier", "fringe_bk"))


@pytest.mark.parametrize("k,num_rows,bn,budget", [
    (96, 60, 128, None), (96, 60, 128, 60_000), (96, 60, 128, 4_096),
    (2048, 500, 256, None), (232_960, 200_000, 256, None), (8, 1, 128, 1),
])
def test_tier_arithmetic_matches_reference(k, num_rows, bn, budget):
    ref = jax_cost_model.select_fringe_tier(k, num_rows, bn,
                                            vmem_budget=budget)
    assert cost_model.select_fringe_tier(
        k, num_rows, bn, vmem_budget=budget, impl="torch") == ref
    cuda = cost_model.select_fringe_tier(k, num_rows, bn,
                                         vmem_budget=budget, impl="cuda")
    assert cuda == (("resident", 0) if ref[0] == "xla" else ref)


def test_cost_model_alpha_matches_reference():
    for n in (64, 256, 1024):
        assert (cost_model.default_cost_model(n).alpha
                == jax_cost_model.default_cost_model(n).alpha)


def test_nm_detectable_matrix_raises():
    """A matrix the reference packs into its N:M lane: the port builds the
    same N:M plan (it refused it before the structured lane was ported),
    and an explicit general hint the same general plan."""
    rows, cols, vals, shape = _spec("dlmc-nm-1-32", 1024)
    ours, theirs = _both(rows, cols, vals, shape)
    assert theirs.matrix_format == ours.matrix_format == "nm"
    _check(ours, theirs)
    ours = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="torch", structure_hint="general"))
    ref = jax_spmm.prepare(
        rows, cols, vals, shape,
        jax_spmm.SpmmConfig(impl="xla", structure_hint="general"))
    _check(ours, ref)


@pytest.mark.parametrize("cfg,match", [
    (dict(autotune=True), "tuner"),
    (dict(structure_hint="bitmap"), "A8"),
    (dict(structure_hint=("nm", 1, 32)), "A8"),
])
def test_unported_options_raise(cfg, match):
    """Options the port once refused.  ``autotune=True`` (the tuner) is
    ported: with the same timer injected into both packages' tuners, each
    measures the same record inline and builds the reference's plan.  The
    structured hints (A8) are ported: the port builds the reference's
    plan, or raises its PlanBuildError."""
    rng = np.random.RandomState(0)
    _, rows, cols, vals = make_sparse(rng, 40, 40, 0.1)
    if match == "tuner":
        from repro.core import tuner as jax_tuner
        from repro_torch.core import tuner
        for t in (tuner, jax_tuner):
            t.reset_for_tests()
            t.set_timer(lambda fn: 1e-3)
        try:
            ours = spmm.prepare(rows, cols, vals, (40, 40),
                                SpmmConfig(impl="torch", **cfg))
            theirs = jax_spmm.prepare(rows, cols, vals, (40, 40),
                                      jax_spmm.SpmmConfig(impl="xla", **cfg))
            assert tuner.tune_call_count() == jax_tuner.tune_call_count() > 0
        finally:
            for t in (tuner, jax_tuner):
                t.reset_for_tests()
        _check(ours, theirs)
        return
    try:
        theirs = jax_spmm.prepare(rows, cols, vals, (40, 40),
                                  jax_spmm.SpmmConfig(impl="xla", **cfg))
    except Exception as err:  # the reference's own PlanBuildError
        assert type(err).__name__ == "PlanBuildError"
        with pytest.raises(PlanBuildError) as ours:
            spmm.prepare(rows, cols, vals, (40, 40),
                         SpmmConfig(impl="torch", **cfg))
        assert str(ours.value) == str(err)
        return
    ours = spmm.prepare(rows, cols, vals, (40, 40),
                        SpmmConfig(impl="torch", **cfg))
    assert ours.matrix_format == theirs.matrix_format
    _check(ours, theirs)


@pytest.mark.parametrize("impl,device", [
    ("cuda", "cpu"), ("torch", "cuda"), ("xla", "cpu"), ("pallas", "cpu"),
])
def test_impl_device_mismatch_raises(impl, device):
    rng = np.random.RandomState(0)
    _, rows, cols, vals = make_sparse(rng, 40, 40, 0.1)
    with pytest.raises(PlanBuildError):
        spmm.prepare(rows, cols, vals, (40, 40), SpmmConfig(impl=impl),
                     device=device)


def test_executor_leaf_order_matches_reference():
    assert plan_ir.N_PLAN_LEAVES == jax_plan_ir.N_PLAN_LEAVES
    assert plan_ir.LEAF_RANKS == jax_plan_ir.LEAF_RANKS
    rows, cols, vals, shape = _spec("cora")
    ours, theirs = _both(rows, cols, vals, shape)
    got = plan_ir.plan_leaves(ours)
    want = jax_plan_ir.plan_leaves(theirs)
    assert len(got) == plan_ir.N_PLAN_LEAVES
    assert [t.ndim for t in got] == list(plan_ir.LEAF_RANKS)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_small_helpers_match_reference():
    for n in (0, 1, 3, 64, 65, 1000):
        assert ops.pow2_at_least(n) == jax_ops.pow2_at_least(n)
    for chunk in (None, 1, 8, 63, 64, 4096):
        assert ops.effective_chunk(chunk) == jax_ops.effective_chunk(chunk)
    rng = np.random.RandomState(4)
    rows = rng.randint(0, 30, 77)
    cols = rng.randint(0, 20, 77)
    vals = rng.randn(77).astype(np.float32)
    ours = formats.coo_from_arrays(rows, cols, vals, (30, 20))
    theirs = jax_formats.coo_from_arrays(rows, cols, vals, (30, 20))
    assert ours.nnz == theirs.nnz and ours.density == theirs.density
    for f in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(ours, f).numpy(),
                              np.asarray(getattr(theirs, f)))
    assert np.array_equal(formats.dense_from_coo(ours),
                          jax_formats.dense_from_coo(theirs))
    before = spmm.prepare_call_count()
    spmm.prepare(rows, cols, vals, (30, 20), SpmmConfig(impl="torch"))
    assert spmm.prepare_call_count() == before + 1
