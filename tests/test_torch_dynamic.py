"""repro_torch value updates (``dynamic.update_values``, ``with_values``).

The contract is bit-identity with a fresh ``prepare`` of the new values, so
every value leaf is compared exactly against the port's own re-prepare (a
match with the reference alone would not do: its own re-prepare check
fails on this tree, because there an update demotes a plan that its
``prepare`` packed into the N:M lane).  Where the reference's value path
passes, the updated leaves are also compared exactly with
``repro.dynamic.update_values``.  Also: the signature and the executor
stay, the original plan is left as it was, and the updated plan computes
what the dense product of the new values gives (1e-5 * max(1, max|ref|)).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import spmm as jax_spmm  # noqa: E402
from repro.dynamic import update_values as jax_update_values  # noqa: E402
import repro_torch.sparse as sp  # noqa: E402
from repro_torch.core import plan_ir, spmm  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig  # noqa: E402
from repro_torch.core.values import set_values  # noqa: E402
from repro_torch.dynamic import update_values  # noqa: E402
from repro_torch.errors import PlanBuildError  # noqa: E402
from repro_torch.exec import api, cache  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    plan_from_arrays, update_maps_from_arrays,
)
from conftest import make_sparse  # noqa: E402

TOL = 1e-5
VALUE_LEAVES = ("flat_values", "fringe_vals", "fringe_kb_vals")
_PORT_FIELDS = {f.name for f in dataclasses.fields(SpmmConfig)}
_MAP_FIELDS = [f.name for f in dataclasses.fields(plan_ir.UpdateMaps)]


def _random_coo(seed, m, k, density):
    rng = np.random.RandomState(seed)
    mask = rng.rand(m, k) < density
    rows, cols = np.nonzero(mask)
    return rows.astype(np.int64), cols.astype(np.int64), rng.randn(rows.size)


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape, np.float64)
    np.add.at(a, (rows, cols), np.asarray(vals, np.float64))
    return a


def _leaves(plan):
    return {n: t.clone() for n, t in plan.leaves().items()}


def _assert_leaves_equal(got, want):
    for name in LEAF_NAMES:
        a = got[name] if isinstance(got, dict) else getattr(got, name)
        b = want[name] if isinstance(want, dict) else getattr(want, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _update_case(rows, cols, vals, shape, seed, **cfg):
    """(plan, updated, re-prepared, idx, new values, all new values)."""
    rng = np.random.RandomState(seed + 100)
    plan = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="torch", **cfg))
    idx = rng.choice(rows.size, max(1, rows.size // 3), replace=False)
    new = rng.randn(idx.size)
    vals2 = np.asarray(vals).copy()
    vals2[idx] = new.astype(vals2.dtype)
    updated = update_values(plan, idx, new)
    fresh = spmm.prepare(rows, cols, vals2, shape,
                         SpmmConfig(impl="torch", **cfg))
    return plan, updated, fresh, idx, new, vals2


PINNED = [
    # (seed, m, k, density, config)
    (0, 64, 64, 0.10, dict()),
    (1, 96, 48, 0.02, dict(alpha=1.0)),                           # all fringe
    (2, 96, 48, 0.50, dict(alpha=1e-9, enable_col_stage=False)),  # all core
    (3, 120, 90, 0.08, dict(reorder_cols=True)),
    (4, 150, 130, 0.05, dict(bm=32, bk=16, bn=128)),
]


@pytest.mark.parametrize("seed,m,k,density,cfg", PINNED)
def test_update_values_matches_reprepare_and_reference(seed, m, k, density,
                                                       cfg):
    rows, cols, vals = _random_coo(seed, m, k, density)
    plan, updated, fresh, idx, new, vals2 = _update_case(
        rows, cols, vals, (m, k), seed, **cfg)
    before = _leaves(plan)
    _assert_leaves_equal(updated, fresh)
    assert updated.signature() == plan.signature() == fresh.signature()
    assert np.array_equal(updated.update_maps.vals, vals2)
    _assert_leaves_equal(plan, before)  # the original plan is untouched
    assert np.array_equal(plan.update_maps.vals, vals)
    # the reference's value path gives the same leaves
    jplan = jax_spmm.prepare(rows, cols, vals, (m, k),
                             jax_spmm.SpmmConfig(impl="xla", **cfg))
    jupd = jax_update_values(jplan, idx, new)
    for name in VALUE_LEAVES:
        assert np.array_equal(getattr(updated, name).numpy(),
                              np.asarray(getattr(jupd, name))), name
    b = np.random.RandomState(seed).randn(k, 12).astype(np.float32)
    got = api.execute(updated, torch.from_numpy(b)).numpy()
    want = _dense(rows, cols, vals2, (m, k)) @ b.astype(np.float64)
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


def test_update_values_keeps_the_executor_and_derived_arrays():
    rng = np.random.RandomState(8)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.02, n_dense_rows=10)
    plan = spmm.prepare(rows, cols, vals, (300, 260),
                        SpmmConfig(impl="torch", seed=31))
    b = torch.from_numpy(rng.randn(260, 16).astype(np.float32))
    x = torch.from_numpy(rng.randn(300, 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(8, 260).astype(np.float32))
    api.execute(plan, b)
    api.execute_sddmm(plan, x, y)
    maps = plan_ir.build_sddmm_maps(plan)
    builds = cache.fused_trace_count()
    updated = update_values(plan, np.arange(rows.size),
                            rng.randn(rows.size))
    api.execute(updated, b)
    api.execute_sddmm(updated, x, y)
    assert cache.fused_trace_count() == builds  # no executor rebuilt
    assert updated.derived is plan.derived
    assert plan_ir.build_sddmm_maps(updated) is maps


def test_update_values_is_bit_exact_on_extreme_magnitudes():
    """A scatter that adds value deltas would fail this: in fp32
    a + (b - a) loses b entirely once |a| >> |b|."""
    rows = np.array([0, 1], np.int64)
    cols = np.array([0, 1], np.int64)
    # a diagonal is an N:M pattern to the reference; keep the general lane
    cfg = SpmmConfig(impl="torch", alpha=1e-9, enable_col_stage=False,
                     structure_hint="general")
    plan = spmm.prepare(rows, cols, np.array([1e8, 2.0], np.float32), (4, 4),
                        cfg)
    updated = update_values(plan, np.array([0]), np.array([1.0], np.float32))
    fresh = spmm.prepare(rows, cols, np.array([1.0, 2.0], np.float32), (4, 4),
                         cfg)
    _assert_leaves_equal(updated, fresh)


@pytest.mark.parametrize("every_value", [False, True])
def test_update_values_recomputes_duplicate_slots_in_input_order(every_value):
    """Some values (slots searched for) or every value (slots read off the
    sorted maps in one pass, as with_values does): the same leaves."""
    rng = np.random.RandomState(12)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.02, n_dense_rows=10)
    dup = rng.choice(rows.size, 300, replace=False)
    rows = np.concatenate([rows, rows[dup], rows[dup[:50]]])
    cols = np.concatenate([cols, cols[dup], cols[dup[:50]]])
    vals = np.concatenate([vals, vals[dup] * 1e4, vals[dup[:50]] * -3e-4])
    if every_value:
        plan = spmm.prepare(rows, cols, vals, (300, 260),
                            SpmmConfig(impl="torch"))
        new = rng.randn(rows.size) * 1e3
        updated = update_values(plan, np.arange(rows.size), new)
        fresh = spmm.prepare(rows, cols, new, (300, 260),
                             SpmmConfig(impl="torch"))
    else:
        plan, updated, fresh, *_ = _update_case(rows, cols, vals,
                                                (300, 260), 12)
    assert plan.has_core and plan.has_fringe
    _assert_leaves_equal(updated, fresh)


def test_update_values_on_a_carried_kbucketed_plan_matches_reference():
    """A plan the reference built for its streaming tier carries a real
    k-bucketed stream; the update writes it as the reference does."""
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 60, 400)
    cols = rng.randint(0, 96, 400)
    vals = rng.randn(400).astype(np.float32)
    jplan = jax_spmm.prepare(
        rows, cols, vals, (60, 96),
        jax_spmm.SpmmConfig(impl="pallas", bn=128, alpha=1.0,
                            fringe_vmem_budget=60_000))
    assert jplan.fringe_tier == "ksharded"
    leaves, _ = jplan.tree_flatten()
    cfg = {k: v for k, v in dataclasses.asdict(jplan.config).items()
           if k in _PORT_FIELDS}
    cfg["impl"] = "torch"
    carried = plan_from_arrays(
        {n: np.asarray(x) for n, x in zip(LEAF_NAMES, leaves)},
        dict(shape=jplan.shape, config=cfg, stats=jplan.stats,
             fringe_tier=jplan.fringe_tier, fringe_bk=jplan.fringe_bk,
             update_maps=update_maps_from_arrays(
                 {n: getattr(jplan.update_maps, n) for n in _MAP_FIELDS})))
    idx = rng.choice(400, 150, replace=False)
    new = rng.randn(150).astype(np.float32)
    ours = update_values(carried, idx, new)
    theirs = jax_update_values(jplan, idx, new)
    for name in VALUE_LEAVES:
        assert np.array_equal(getattr(ours, name).numpy(),
                              np.asarray(getattr(theirs, name))), name
    assert not np.array_equal(ours.fringe_kb_vals.numpy(),
                              carried.fringe_kb_vals.numpy())


def test_set_values_writes_a_carried_kbucketed_stream():
    """A plan the reference built for its streaming tier carries a real
    k-bucketed stream; the device write fills it as a fresh build does."""
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 60, 400)
    cols = rng.randint(0, 96, 400)
    vals = rng.randn(400).astype(np.float32)
    jcfg = jax_spmm.SpmmConfig(impl="pallas", bn=128, alpha=1.0,
                               fringe_vmem_budget=60_000)

    def carried(v):
        jplan = jax_spmm.prepare(rows, cols, v, (60, 96), jcfg)
        assert jplan.fringe_tier == "ksharded"
        leaves, _ = jplan.tree_flatten()
        cfg = {k: x for k, x in dataclasses.asdict(jplan.config).items()
               if k in _PORT_FIELDS}
        cfg["impl"] = "torch"
        return plan_from_arrays(
            {n: np.asarray(x) for n, x in zip(LEAF_NAMES, leaves)},
            dict(shape=jplan.shape, config=cfg, stats=jplan.stats,
                 fringe_tier=jplan.fringe_tier, fringe_bk=jplan.fringe_bk,
                 update_maps=update_maps_from_arrays(
                     {n: getattr(jplan.update_maps, n)
                      for n in _MAP_FIELDS})))

    plan = carried(vals)
    new = rng.randn(400).astype(np.float32)
    got = set_values(plan, torch.from_numpy(new))
    want = carried(new)
    for name in ("fringe_vals", "fringe_kb_vals"):
        assert np.array_equal(getattr(got, name).numpy().view(np.int32),
                              getattr(want, name).numpy().view(np.int32)), \
            name
    assert got.fringe_kb_vals.numel() > 1


def test_with_values_takes_numpy_and_tensors():
    rng = np.random.RandomState(3)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.02, n_dense_rows=10)
    A = sp.from_coo(rows, cols, vals, (300, 260), device="cpu")
    new = rng.randn(rows.size).astype(np.float32)
    A1 = A.with_values(new)
    A2 = A.with_values(torch.from_numpy(new))
    _assert_leaves_equal(A1.plan, A2.plan)
    fresh = sp.from_coo(rows, cols, new, (300, 260), device="cpu")
    _assert_leaves_equal(A1.plan, fresh.plan)
    assert np.array_equal(A.val, vals) and np.array_equal(A1.val, new)
    assert np.array_equal(A1.row, rows) and np.array_equal(A1.col, cols)
    b = torch.from_numpy(rng.randn(260, 9).astype(np.float32))
    assert torch.equal(sp.spmm(A1, b), sp.spmm(fresh, b))
    with pytest.raises(ValueError, match="one value per nonzero"):
        A.with_values(new[:-1])
    with pytest.raises(ValueError, match="one value per nonzero"):
        A.with_values(torch.from_numpy(new).reshape(1, -1))


def test_update_values_rejects_bad_input():
    rows, cols, vals = _random_coo(0, 30, 30, 0.1)
    plan = spmm.prepare(rows, cols, vals, (30, 30), SpmmConfig(impl="torch"))
    with pytest.raises(PlanBuildError, match="out of range"):
        update_values(plan, np.array([rows.size]), np.array([1.0]))
    with pytest.raises(PlanBuildError, match="disagree"):
        update_values(plan, np.array([0, 1]), np.array([1.0]))
    with pytest.raises(PlanBuildError, match="1-D"):
        update_values(plan, np.zeros((1, 1), np.int64), np.ones((1, 1)))
    with pytest.raises(PlanBuildError, match="update maps"):
        update_values(dataclasses.replace(plan, update_maps=None),
                      np.array([0]), np.array([1.0]))


def test_update_values_of_no_indices_changes_nothing():
    rows, cols, vals = _random_coo(1, 40, 40, 0.1)
    plan = spmm.prepare(rows, cols, vals, (40, 40), SpmmConfig(impl="torch"))
    same = update_values(plan, np.zeros(0, np.int64), np.zeros(0))
    _assert_leaves_equal(same, plan)


def test_sddmm_then_with_values_then_spmm_round_trip():
    """The GAT cycle on the facade: scores from sddmm land as the values of
    the same pattern; spmm then aggregates with them."""
    rng = np.random.RandomState(21)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.02, n_dense_rows=10)
    A = sp.from_coo(rows, cols, vals, (300, 260), device="cpu")
    x = rng.randn(300, 6).astype(np.float32)
    y = rng.randn(6, 260).astype(np.float32)
    b = rng.randn(260, 5).astype(np.float32)
    w = sp.sddmm(A, x, y)
    out = sp.spmm(A.with_values(w), b).numpy()
    scores = (x.astype(np.float64) @ y)[rows, cols]
    want = _dense(rows, cols, scores, (300, 260)) @ b.astype(np.float64)
    assert np.abs(out - want).max() <= TOL * max(1.0, np.abs(want).max())
    jA = jax_spmm.prepare(rows, cols, vals, (300, 260),
                          jax_spmm.SpmmConfig(impl="xla"))
    from repro.exec.api import execute_sddmm as jax_sddmm

    jw = np.asarray(jax_sddmm(jA, jnp.asarray(x), jnp.asarray(y)))
    assert np.abs(w.numpy() - jw).max() <= TOL * max(1.0, np.abs(jw).max())
