"""The port's dynamic plans (``repro_torch.dynamic``) against the JAX
package's, on the CPU.

The same seeded COO and mutation batches go through ``repro.dynamic`` on
``impl="xla"`` and through the port on ``impl="torch"``: the sidecar's
eight leaves and signature must be equal (the ``"cuda"`` layout is held
against the reference's ``"pallas"`` one, whose k-bucketed stream it
shares), as must ``to_coo``, the routing stats, the compaction decisions
and the folded plan's leaves; ``DynamicPlan.execute`` and B's gradient
must agree within 1e-5 * max(1, max|ref|) at every step.  The reference's
single-device tests of ``tests/test_dynamic.py`` (the structural sidecar,
its error cases, atomic batches, capacity growth and reset, compaction)
are mirrored against the fp64 dense product (1e-4, as there).  The walk
the card runs over a sidecar (its stable row order, padding entries
included) is emulated with the plain gather and held against the
reference's oracle, also with an Inf in B's row 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plan_ir as jax_plan_ir  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.core.cost_model import (  # noqa: E402
    should_compact as jax_should_compact,
)
from repro.data import graphs as jax_graphs  # noqa: E402
from repro.dynamic import DynamicPlan as JaxDynamicPlan  # noqa: E402
from repro.dynamic import GraphDelta as JaxGraphDelta  # noqa: E402
from repro.exec.api import (  # noqa: E402
    execute_delta_contribution as jax_execute_delta_contribution,
)
from repro.kernels import ref as jax_ref  # noqa: E402
import repro_torch.sparse as sp  # noqa: E402
from repro_torch.core import spmm  # noqa: E402
from repro_torch.core.cost_model import (  # noqa: E402
    default_cost_model, fringe_resident_bytes, should_compact,
)
from repro_torch.core.plan_ir import (  # noqa: E402
    LEAF_NAMES, build_delta_fringe,
)
from repro_torch.data import graphs  # noqa: E402
from repro_torch.dynamic import DynamicPlan, GraphDelta  # noqa: E402
from repro_torch.errors import PlanBuildError  # noqa: E402
from repro_torch.exec import api, cache  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.gather_spmm import (  # noqa: E402
    kbucket_row_order, stream_row_order,
)

BN = 128
TOL_REF = 1e-5
TOL_DENSE = 1e-4
# fringe_vmem_budget forcing each sidecar tier for the shapes below (K =
# 600, capacities up to 256): "ksharded" leaves room for a k-block slice
# stream beside 256 packed rows but not for the resident B panel
TIER_BUDGET = {"resident": None, "ksharded": 400 * BN * 4, "xla": 16}


def _random_coo(seed, m, k, density):
    rng = np.random.RandomState(seed)
    mask = rng.rand(m, k) < density
    rows, cols = np.nonzero(mask)
    return rows.astype(np.int64), cols.astype(np.int64), rng.randn(rows.size)


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape, np.float64)
    if rows.size:
        np.add.at(a, (rows, cols), np.asarray(vals, np.float64))
    return a


def _configs(**kw):
    return (spmm.SpmmConfig(impl="torch", bn=BN, **kw),
            jax_spmm.SpmmConfig(impl="xla", bn=BN, **kw))


def _pair(rows, cols, vals, shape, **dyn_kw):
    """(port, reference) DynamicPlans on the same COO."""
    cfg_kw = dyn_kw.pop("cfg", {})
    cfg, jcfg = _configs(**cfg_kw)
    port = DynamicPlan(spmm.prepare(rows, cols, vals, shape, cfg,
                                    device="cpu"), **dyn_kw)
    want = JaxDynamicPlan(jax_spmm.prepare(rows, cols, vals, shape, jcfg),
                          **dyn_kw)
    return port, want


def _jax_delta(d):
    return JaxGraphDelta(**{f.name: getattr(d, f.name)
                            for f in dataclasses.fields(d)})


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size \
        else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max()) if want.size
                            else 0.0), err


def _assert_sidecar_equal(port_df, ref_df):
    assert port_df.sig == ref_df.sig
    assert (port_df.capacity, port_df.count, port_df.tier, port_df.bk) == (
        ref_df.capacity, ref_df.count, ref_df.tier, ref_df.bk)
    assert len(port_df.leaves) == len(ref_df.leaves) == 8
    for i, (a, b) in enumerate(zip(port_df.leaves, ref_df.leaves)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, i
        assert np.array_equal(a.numpy(), b), i


def _check_dense(dp, dense, b, tol=TOL_DENSE):
    out = dp.execute(torch.from_numpy(b))
    expect = dense @ b.astype(np.float64)
    scale = np.abs(expect).max() + 1e-9
    assert np.abs(out.numpy() - expect).max() / scale < tol


def _apply_delta_dense(dense, delta):
    for r, c, v in zip(delta.ins_rows, delta.ins_cols, delta.ins_vals):
        dense[r, c] += v
    for r, c in zip(delta.del_rows, delta.del_cols):
        dense[r, c] = 0.0
    for r, c, v in zip(delta.upd_rows, delta.upd_cols, delta.upd_vals):
        dense[r, c] = v


# ---------------------------------------------------------------------------
# the sidecar layout against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("count", [0, 1, 37, 200])
@pytest.mark.parametrize("tier", ["resident", "ksharded", "xla"])
def test_sidecar_leaves_match_reference(count, tier):
    rng = np.random.RandomState(count + 7)
    shape = (90, 600)
    key = rng.choice(shape[0] * shape[1], count, replace=False)
    d_rows, d_cols = key // shape[1], key % shape[1]
    d_vals = rng.randn(count)
    budget = TIER_BUDGET[tier]
    cfg, jcfg = _configs(fringe_vmem_budget=budget, fringe_chunk=5)
    got = build_delta_fringe(d_rows, d_cols, d_vals, shape, cfg)
    want = jax_plan_ir.build_delta_fringe(d_rows, d_cols, d_vals, shape,
                                          jcfg)
    assert got.tier == tier
    _assert_sidecar_equal(got, want)
    assert all(t.device.type == "cpu" for t in got.leaves)
    # a grown capacity pads further and changes the signature
    grown = build_delta_fringe(d_rows, d_cols, d_vals, shape, cfg,
                               capacity=512)
    _assert_sidecar_equal(grown, jax_plan_ir.build_delta_fringe(
        d_rows, d_cols, d_vals, shape, jcfg, capacity=512))
    if tier != "xla":
        # the card's layout: the k-bucketed sidecar is the reference's
        # "pallas" one; the "xla" tier is the H100 rule's "resident"
        cfg_c = dataclasses.replace(cfg, impl="cuda")
        jcfg_p = dataclasses.replace(jcfg, impl="pallas")
        _assert_sidecar_equal(
            build_delta_fringe(d_rows, d_cols, d_vals, shape, cfg_c,
                               device="cpu"),
            jax_plan_ir.build_delta_fringe(d_rows, d_cols, d_vals, shape,
                                           jcfg_p))
    else:
        cuda = build_delta_fringe(d_rows, d_cols, d_vals, shape,
                                  dataclasses.replace(cfg, impl="cuda"),
                                  device="cpu")
        assert cuda.tier == "resident"


@pytest.mark.parametrize("tier", ["resident", "ksharded"])
def test_card_walk_over_sidecar_matches_reference_oracle(tier):
    """What the card computes on a sidecar: B2's walk over the stream in
    its stable row order (padding entries in row 0), or B3's over the
    remapped k-bucketed sidecar, emulated with the plain gather, against
    the reference's oracle on the padded stream; with an Inf in B's row 0
    the padding entries give NaN in packed row 0 in both."""
    rng = np.random.RandomState(3)
    shape = (90, 600)
    key = rng.choice(shape[0] * shape[1], 150, replace=False)
    cfg = spmm.SpmmConfig(impl="cuda", bn=BN,
                          fringe_vmem_budget=TIER_BUDGET[tier])
    df = build_delta_fringe(key // shape[1], key % shape[1],
                            rng.randn(150), shape, cfg, device="cpu")
    assert df.tier == tier and df.capacity == 256
    rows, cols, vals, _gsrc, kbc, kbr, kbcol, kbv = df.leaves
    assert not bool((rows[1:] >= rows[:-1]).all())  # padded: not sorted
    cap = df.capacity
    for inf in (False, True):
        b = rng.randn(shape[1], 24).astype(np.float32)
        if inf:
            b[0, 5] = np.inf
        bt = torch.from_numpy(b)
        if tier == "ksharded":
            order = kbucket_row_order(kbc, kbr, kbcol, cap, df.bk)
            v = kbv
        else:
            order = stream_row_order(rows, cols, cap)
            v = vals
        walk_rows = torch.repeat_interleave(
            torch.arange(cap), (order.indptr[1:] - order.indptr[:-1]).long())
        got = ref.ref_gather_spmm(walk_rows, order.cols, v[order.perm.long()],
                                  bt, cap).numpy()
        want = np.asarray(jax_ref.ref_gather_spmm(
            jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
            jnp.asarray(vals.numpy()), jnp.asarray(b), cap))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert bool(np.isnan(want[0, 5])) == inf
        fin = np.isfinite(want)
        _close(got[fin], want[fin], TOL_REF)


# ---------------------------------------------------------------------------
# DynamicPlan against the reference's, step by step
# ---------------------------------------------------------------------------
def test_mutate_matches_reference():
    rows, cols, vals = _random_coo(19, 60, 60, 0.08)
    kw = dict(steps=5, insert_frac=0.05, delete_frac=0.04, update_frac=0.1,
              seed=2)
    got = list(graphs.mutate(rows, cols, vals, (60, 60), **kw))
    want = list(jax_graphs.mutate(rows, cols, vals, (60, 60), **kw))
    assert len(got) == len(want) == 5
    for d, jd in zip(got, want):
        for f in dataclasses.fields(d):
            a, b = getattr(d, f.name), getattr(jd, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.mark.parametrize("tier", ["resident", "ksharded", "xla"])
def test_dynamic_plan_matches_reference_every_step(tier):
    rows, cols, vals = _random_coo(23, 90, 600, 0.01)
    shape = (90, 600)
    port, want = _pair(rows, cols, vals, shape, auto_compact=False,
                       cfg=dict(fringe_vmem_budget=TIER_BUDGET[tier]))
    b = np.random.RandomState(1).randn(600, 16).astype(np.float32)
    tiers = set()
    for d in graphs.mutate(rows, cols, vals, shape, steps=3,
                           insert_frac=0.08, delete_frac=0.04,
                           update_frac=0.1, seed=4):
        stats = port.update(d)
        assert stats == want.update(_jax_delta(d))
        assert vars(port.last_decision) == vars(want.last_decision)
        for a, c in zip(port.to_coo(), want.to_coo()):
            assert np.array_equal(a, c)
        _close(port.execute(torch.from_numpy(b)),
               want.execute(jnp.asarray(b)), TOL_REF)
        _assert_sidecar_equal(port._delta, want._delta)
        tiers.add(port._delta.tier)
        assert port.version == want.version
    assert tiers == {tier}
    # the fold: the folded plan's leaves are the reference's prepare
    port.compact()
    want.compact()
    for name in LEAF_NAMES:
        assert np.array_equal(getattr(port.plan, name).numpy(),
                              np.asarray(getattr(want.plan, name))), name
    assert port.plan.signature()[1:5] == want.plan.signature()[1:5]
    _close(port.execute(torch.from_numpy(b)), want.execute(jnp.asarray(b)),
           TOL_REF)


def test_auto_compaction_matches_reference():
    """With the cost model's thresholds the fold lands at the same step in
    both packages, and the folded leaves are equal."""
    rows, cols, vals = _random_coo(13, 80, 80, 0.05)
    port, want = _pair(rows, cols, vals, (80, 80))
    b = np.random.RandomState(2).randn(80, 8).astype(np.float32)
    folds = []
    for d in graphs.mutate(rows, cols, vals, (80, 80), steps=6,
                           insert_frac=0.03, delete_frac=0.03,
                           update_frac=0.05, seed=6):
        stats = port.update(d)
        assert stats == want.update(_jax_delta(d))
        assert vars(port.last_decision) == vars(want.last_decision)
        folds.append(stats["compacted"])
        _close(port.execute(torch.from_numpy(b)),
               want.execute(jnp.asarray(b)), TOL_REF)
    assert any(folds) and port.compactions == want.compactions
    for name in LEAF_NAMES:
        assert np.array_equal(getattr(port.plan, name).numpy(),
                              np.asarray(getattr(want.plan, name))), name


@pytest.mark.parametrize("case", [
    dict(base_nnz=1000, delta_nnz=0, core_rows=128, fringe_nnz=500, k=256),
    dict(base_nnz=1000, delta_nnz=600, core_rows=128, fringe_nnz=500, k=256),
    dict(base_nnz=10**9, delta_nnz=10**6, core_rows=8, fringe_nnz=10, k=8),
    dict(base_nnz=10**6, delta_nnz=10, core_rows=4096, fringe_nnz=10**5,
         k=1024),
    dict(base_nnz=0, delta_nnz=30, core_rows=0, fringe_nnz=0, k=40),
    dict(base_nnz=0, delta_nnz=300, core_rows=0, fringe_nnz=0, k=40),
])
def test_should_compact_matches_reference(case):
    from repro.core.cost_model import default_cost_model as jax_cm

    got = should_compact(default_cost_model(), **case)
    assert vars(got) == vars(jax_should_compact(jax_cm(), **case))


def test_should_compact_policy():
    cm = default_cost_model()
    no = should_compact(cm, base_nnz=1000, delta_nnz=0, core_rows=128,
                        fringe_nnz=500, k=256)
    assert not no.compact and no.reason == "empty delta"
    frac = should_compact(cm, base_nnz=1000, delta_nnz=600, core_rows=128,
                          fringe_nnz=500, k=256)
    assert frac.compact and "fraction" in frac.reason
    slow = should_compact(cm, base_nnz=10**9, delta_nnz=10**6, core_rows=8,
                          fringe_nnz=10, k=8)
    assert slow.compact and "slowdown" in slow.reason
    ok = should_compact(cm, base_nnz=10**6, delta_nnz=10, core_rows=4096,
                        fringe_nnz=10**5, k=1024)
    assert not ok.compact


@pytest.mark.parametrize("tier", ["resident", "ksharded", "xla"])
def test_gradient_in_b_matches_jax_grad(tier):
    """B's gradient through the base plan (the transpose plan) and the
    sidecar (the transposed sidecar), against ``jax.grad`` of the
    reference's ``DynamicPlan.execute``; A is not symmetric."""
    rows, cols, vals = _random_coo(29, 70, 600, 0.012)
    port, want = _pair(rows, cols, vals, (70, 600), auto_compact=False,
                       cfg=dict(fringe_vmem_budget=TIER_BUDGET[tier]))
    for d in graphs.mutate(rows, cols, vals, (70, 600), steps=2,
                           insert_frac=0.1, delete_frac=0.05,
                           update_frac=0.1, seed=8):
        port.update(d)
        want.update(_jax_delta(d))
    assert port.delta_nnz > 0
    rng = np.random.RandomState(3)
    b = rng.randn(600, 12).astype(np.float32)
    g = rng.randn(70, 12).astype(np.float32)
    bt = torch.from_numpy(b).requires_grad_(True)
    (port.execute(bt) * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda x: (want.execute(x) * g).sum())(jnp.asarray(b))
    _close(bt.grad, jg, TOL_REF)
    # the same through the facade, batched
    a = sp.from_plan(port)
    bb = torch.from_numpy(np.stack([b, 2 * b])).requires_grad_(True)
    (sp.bspmm(a, bb) * torch.from_numpy(g)).sum().backward()
    _close(bb.grad[0], jg, TOL_REF)
    _close(bb.grad[1], jg, TOL_REF)


def test_delta_contribution_matches_reference():
    rows, cols, vals = _random_coo(31, 50, 60, 0.1)
    port, want = _pair(rows, cols, vals, (50, 60), auto_compact=False)
    rng = np.random.RandomState(4)
    zr, zc = np.nonzero(_dense(rows, cols, vals, (50, 60)) == 0)
    pick = rng.choice(zr.size, 9, replace=False)
    ins = GraphDelta.inserts(zr[pick], zc[pick], rng.randn(9))
    port.update(ins)
    want.update(_jax_delta(ins))
    b = rng.randn(60, 8).astype(np.float32)
    got = api.execute_delta_contribution(port.shape, port.config,
                                         port._materialize(),
                                         torch.from_numpy(b))
    _close(got, jax_execute_delta_contribution(
        want.shape, want.config, want._materialize(), jnp.asarray(b)),
        TOL_REF)
    # fused = base + contribution
    base = api.execute(port.plan, torch.from_numpy(b))
    _close(port.execute(torch.from_numpy(b)), (base + got).numpy(), TOL_REF)


# ---------------------------------------------------------------------------
# the reference's single-device tests, against the dense product
# ---------------------------------------------------------------------------
def _tier_cfg(tier, rows, k):
    num_rows = max(np.unique(rows).size, 1)
    k_pad = ((k + 63) // 64) * 64
    budget = {"resident": None,
              "ksharded": fringe_resident_bytes(k_pad, num_rows, BN) - 1,
              "xla": 16}[tier]
    return spmm.SpmmConfig(impl="torch", bn=BN, alpha=1.0,
                           fringe_vmem_budget=budget)


def _dyn(rows, cols, vals, shape, cfg=None, **kw):
    cfg = cfg or spmm.SpmmConfig(impl="torch")
    return DynamicPlan(spmm.prepare(rows, cols, vals, shape, cfg,
                                    device="cpu"), **kw)


@pytest.mark.parametrize("tier", ["resident", "ksharded", "xla"])
def test_structural_delta_matches_dense_all_tiers(tier, rng):
    rows, cols, vals = _random_coo(11, 48, 56, 0.12)
    cfg = _tier_cfg(tier, rows, 56)
    plan = spmm.prepare(rows, cols, vals, (48, 56), cfg, device="cpu")
    assert plan.fringe_tier == tier
    dp = DynamicPlan(plan, auto_compact=False)
    dense = _dense(rows, cols, vals, (48, 56))
    b = rng.randn(56, 24).astype(np.float32)

    zr, zc = np.nonzero(dense == 0)
    pick = rng.choice(zr.size, 12, replace=False)
    ins = GraphDelta.inserts(zr[pick], zc[pick], rng.randn(12))
    dp.update(ins)
    _apply_delta_dense(dense, ins)
    _check_dense(dp, dense, b)

    dpick = rng.choice(rows.size, 8, replace=False)
    dele = GraphDelta.deletes(rows[dpick], cols[dpick])
    dp.update(dele)
    _apply_delta_dense(dense, dele)
    rest = np.setdiff1d(np.arange(rows.size), dpick)[:10]
    upd = GraphDelta.updates(rows[rest], cols[rest], rng.randn(10))
    dp.update(upd)
    _apply_delta_dense(dense, upd)
    _check_dense(dp, dense, b)

    # forced compaction folds the sidecar into a fresh plan: same answer
    assert dp.delta_nnz > 0
    dp.compact()
    assert dp.delta_nnz == 0 and dp.compactions == 1
    _check_dense(dp, dense, b)


def test_delta_roundtrip_delete_reinstate(rng):
    rows = np.array([0, 1, 2], np.int64)
    cols = np.array([0, 1, 2], np.int64)
    vals = np.array([1.0, 2.0, 3.0])
    dp = _dyn(rows, cols, vals, (4, 4), auto_compact=False)
    dense = _dense(rows, cols, vals, (4, 4))
    b = rng.randn(4, 8).astype(np.float32)
    dp.update(GraphDelta.deletes([1], [1]))
    dense[1, 1] = 0
    _check_dense(dp, dense, b)
    dp.update(GraphDelta.inserts([1], [1], [7.0]))
    dense[1, 1] = 7.0
    _check_dense(dp, dense, b)
    dp.update(GraphDelta.updates([1], [1], [-2.5]))
    dense[1, 1] = -2.5
    _check_dense(dp, dense, b)
    dp.update(GraphDelta.deletes([1], [1]))
    dense[1, 1] = 0
    _check_dense(dp, dense, b)
    # insert onto a live base entry accumulates (COO-duplicate semantics)
    dp.update(GraphDelta.inserts([0], [0], [0.5]))
    dense[0, 0] += 0.5
    _check_dense(dp, dense, b)
    # sidecar-only insert deletes cleanly back out
    dp.update(GraphDelta.inserts([3], [3], [4.0]))
    dp.update(GraphDelta.deletes([3], [3]))
    _check_dense(dp, dense, b)


def test_delta_error_cases():
    dp = _dyn(np.array([0]), np.array([0]), np.array([1.0]), (4, 4),
              auto_compact=False)
    with pytest.raises(PlanBuildError, match="absent"):
        dp.update(GraphDelta.deletes([2], [2]))
    with pytest.raises(PlanBuildError, match="absent"):
        dp.update(GraphDelta.updates([2], [2], [1.0]))
    dp.update(GraphDelta.deletes([0], [0]))
    with pytest.raises(PlanBuildError, match="deleted"):
        dp.update(GraphDelta.updates([0], [0], [1.0]))
    with pytest.raises(PlanBuildError, match="already deleted"):
        dp.update(GraphDelta.deletes([0], [0]))
    with pytest.raises(PlanBuildError, match="out of range"):
        dp.update(GraphDelta.inserts([9], [0], [1.0]))
    with pytest.raises(PlanBuildError, match="disagree"):
        GraphDelta.inserts([1, 2], [1], [1.0])
    with pytest.raises(PlanBuildError, match="reorder_cols"):
        _dyn(np.array([0]), np.array([0]), np.array([1.0]), (4, 4),
             cfg=spmm.SpmmConfig(impl="torch", reorder_cols=True))
    with pytest.raises(TypeError, match="NeutronPlan"):
        DynamicPlan(object())


def test_update_of_duplicate_base_entry_sets_logical_value(rng):
    rows = np.array([0, 0, 1], np.int64)
    cols = np.array([0, 0, 1], np.int64)
    vals = np.array([1.0, 2.0, 3.0])
    dp = _dyn(rows, cols, vals, (4, 4), auto_compact=False)
    b = rng.randn(4, 8).astype(np.float32)
    stats = dp.update(GraphDelta.updates([0], [0], [5.0]))
    assert stats["delta_nnz"] == 0  # pure fast path
    dense = np.zeros((4, 4))
    dense[0, 0], dense[1, 1] = 5.0, 3.0
    _check_dense(dp, dense, b)
    dp.update(GraphDelta.inserts([0], [0], [1.5]))
    dense[0, 0] += 1.5
    _check_dense(dp, dense, b)
    dp.update(GraphDelta.deletes([0], [0]))
    dense[0, 0] = 0
    _check_dense(dp, dense, b)


def test_repeated_inserts_in_one_batch_accumulate(rng):
    dp = _dyn(np.array([0, 1]), np.array([0, 1]), np.array([5.0, 1.0]),
              (4, 4), auto_compact=False)
    b = rng.randn(4, 8).astype(np.float32)
    dp.update(GraphDelta.inserts([0, 0], [0, 0], [1.0, 2.0]))
    dense = np.zeros((4, 4))
    dense[0, 0], dense[1, 1] = 8.0, 1.0
    _check_dense(dp, dense, b)
    dp.update(GraphDelta.inserts([2, 2], [2, 2], [1.0, 2.0]))
    dense[2, 2] = 3.0
    _check_dense(dp, dense, b)


def test_replace_style_batch_applies_in_order(rng):
    dp = _dyn(np.array([1]), np.array([1]), np.array([2.0]), (4, 4),
              auto_compact=False)
    b = rng.randn(4, 8).astype(np.float32)
    dp.update(GraphDelta(
        del_rows=np.array([1]), del_cols=np.array([1]),
        ins_rows=np.array([1]), ins_cols=np.array([1]),
        ins_vals=np.array([9.0])))
    dense = np.zeros((4, 4))
    dense[1, 1] = 9.0
    _check_dense(dp, dense, b)
    dp.update(GraphDelta(
        ins_rows=np.array([2]), ins_cols=np.array([2]),
        ins_vals=np.array([1.0]),
        upd_rows=np.array([2]), upd_cols=np.array([2]),
        upd_vals=np.array([5.0])))
    dense[2, 2] = 5.0
    _check_dense(dp, dense, b)


def test_compaction_resets_sidecar_capacity(rng):
    rows, cols, vals = _random_coo(31, 40, 40, 0.1)
    dense = _dense(rows, cols, vals, (40, 40))
    dp = _dyn(rows, cols, vals, (40, 40), auto_compact=False)
    b = rng.randn(40, 8).astype(np.float32)
    zr, zc = np.nonzero(dense == 0)
    pick = rng.choice(zr.size, 40, replace=False)
    iv = rng.randn(40)
    dp.update(GraphDelta.inserts(zr[pick], zc[pick], iv))
    dense[zr[pick], zc[pick]] += iv
    dp.execute(torch.from_numpy(b))
    assert dp._capacity == 64
    dp.compact()
    more = np.setdiff1d(np.flatnonzero((dense == 0).ravel()),
                        zr[pick] * 40 + zc[pick])[:1]
    dp.update(GraphDelta.inserts(more // 40, more % 40, [1.0]))
    dense[more // 40, more % 40] += 1.0
    _check_dense(dp, dense, b)
    assert dp._capacity == 8  # minimal again, not the historical 64


def test_failed_update_batch_leaves_state_untouched(rng):
    dp = _dyn(np.array([0, 1]), np.array([0, 1]), np.array([1.0, 2.0]),
              (4, 4), auto_compact=False)
    b = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    dp.update(GraphDelta.inserts([2], [2], [9.0]))  # sidecar built
    before = dp.execute(b).clone()
    overlay_before = dict(dp._overlay)
    version = dp.version
    bad = GraphDelta(
        ins_rows=np.array([3]), ins_cols=np.array([3]),
        ins_vals=np.array([4.0]),                        # valid insert...
        del_rows=np.array([3]), del_cols=np.array([0]))  # ...absent delete
    with pytest.raises(PlanBuildError, match="absent"):
        dp.update(bad)
    assert dp._overlay == overlay_before and dp.version == version
    assert torch.equal(dp.execute(b), before)
    dp.update(GraphDelta.inserts([3], [3], [4.0]))
    dense = np.zeros((4, 4))
    dense[0, 0], dense[1, 1], dense[2, 2], dense[3, 3] = 1.0, 2.0, 9.0, 4.0
    _check_dense(dp, dense, b.numpy())


def test_value_only_mutations_stay_on_fast_path(rng):
    rows, cols, vals = _random_coo(5, 50, 50, 0.1)
    dp = _dyn(rows, cols, vals, (50, 50))
    idx = rng.choice(rows.size, 10, replace=False)
    stats = dp.update(GraphDelta.updates(rows[idx], cols[idx],
                                         rng.randn(10)))
    assert stats["fast_path"] == 10
    assert stats["delta_nnz"] == 0 and dp.delta_nnz == 0


def test_auto_compaction_triggers_and_preserves_answer(rng):
    rows, cols, vals = _random_coo(13, 40, 40, 0.1)
    dense = _dense(rows, cols, vals, (40, 40))
    dp = _dyn(rows, cols, vals, (40, 40), max_delta_fraction=0.02)
    b = rng.randn(40, 8).astype(np.float32)
    zr, zc = np.nonzero(dense == 0)
    pick = rng.choice(zr.size, 20, replace=False)
    ins = GraphDelta.inserts(zr[pick], zc[pick], rng.randn(20))
    stats = dp.update(ins)
    _apply_delta_dense(dense, ins)
    assert stats["compacted"] == 1
    assert dp.delta_nnz == 0 and dp.compactions == 1
    assert dp.last_decision is not None and dp.last_decision.compact
    _check_dense(dp, dense, b)


def test_grow_from_empty_never_churns_compaction(rng):
    m = k = 40
    empty = np.array([], np.int64)
    dp = _dyn(empty, empty, np.array([], np.float64), (m, k))
    dense = np.zeros((m, k), np.float64)
    b = rng.randn(k, 8).astype(np.float32)
    lin = rng.choice(m * k, 30, replace=False)
    before = spmm.prepare_call_count()
    for j in range(6):
        batch = lin[5 * j: 5 * (j + 1)]
        ins = GraphDelta.inserts(batch // k, batch % k, rng.randn(5))
        dp.update(ins)
        _apply_delta_dense(dense, ins)
        assert np.isfinite(dp.last_decision.est_slowdown)
    assert dp.compactions == 0
    assert spmm.prepare_call_count() == before
    assert dp.delta_nnz == 30
    _check_dense(dp, dense, b)


def test_delta_capacity_growth_is_logarithmic(rng):
    """24 single-insert batches build at most one executor per capacity
    (8, 16, 32): ``exec_traces_total`` counts builds."""
    rows, cols, vals = _random_coo(17, 40, 41, 0.05)
    dense = _dense(rows, cols, vals, (40, 41))
    dp = _dyn(rows, cols, vals, (40, 41), auto_compact=False)
    b = torch.from_numpy(rng.randn(41, 8).astype(np.float32))
    zr, zc = np.nonzero(dense == 0)
    pick = rng.choice(zr.size, 24, replace=False)
    before = cache.fused_trace_count()
    dispatches = cache.dispatch_count()
    caps = set()
    for j in range(24):
        dp.update(GraphDelta.inserts([zr[pick[j]]], [zc[pick[j]]],
                                     [float(rng.randn())]))
        dp.execute(b)
        caps.add(dp._capacity)
    assert caps <= {8, 16, 32}
    assert cache.fused_trace_count() - before <= len(caps)
    assert cache.dispatch_count() - dispatches == 24
    _check_dense(dp, _dense(*dp.to_coo(), (40, 41)), b.numpy())


def test_value_updates_never_retrace(rng):
    """Value updates, on a plan and on a dynamic plan with a pending
    sidecar, build no executor: ``exec_traces_total`` stays flat."""
    rows, cols, vals = _random_coo(7, 72, 61, 0.1)
    dp = _dyn(rows, cols, vals, (72, 61), auto_compact=False)
    dense = _dense(rows, cols, vals, (72, 61))
    b = rng.randn(61, 8).astype(np.float32)
    zr, zc = np.nonzero(dense == 0)
    ins = GraphDelta.inserts(zr[:3], zc[:3], [1.0, 2.0, 3.0])
    dp.update(ins)
    _apply_delta_dense(dense, ins)
    dp.execute(torch.from_numpy(b))
    before = cache.fused_trace_count()
    delta = dp._delta
    for _ in range(5):
        idx = rng.choice(rows.size, 9, replace=False)
        upd = GraphDelta.updates(rows[idx], cols[idx], rng.randn(9))
        assert dp.update(upd)["fast_path"] == 9
        _apply_delta_dense(dense, upd)
        _check_dense(dp, dense, b)
        assert dp._delta is delta  # the sidecar is not rebuilt
    assert cache.fused_trace_count() == before


def test_mutate_stream_matches_dense_mirror(rng):
    rows, cols, vals = _random_coo(19, 60, 60, 0.08)
    dense = _dense(rows, cols, vals, (60, 60))
    dp = _dyn(rows, cols, vals, (60, 60))
    b = rng.randn(60, 8).astype(np.float32)
    for delta in graphs.mutate(rows, cols, vals, (60, 60), steps=6,
                               insert_frac=0.05, delete_frac=0.04,
                               update_frac=0.1, seed=2):
        dp.update(delta)
        _apply_delta_dense(dense, delta)
        _check_dense(dp, dense, b)


def test_snapshot_adopt_rejects_stale_fold(rng):
    rows, cols, vals = _random_coo(37, 30, 30, 0.1)
    dp = _dyn(rows, cols, vals, (30, 30), auto_compact=False)
    zr, zc = np.nonzero(_dense(rows, cols, vals, (30, 30)) == 0)
    dp.update(GraphDelta.inserts(zr[:2], zc[:2], [1.0, 2.0]))
    version, r, c, v = dp.snapshot_for_compaction()
    folded = dp.build_compacted(r, c, v)
    dp.update(GraphDelta.inserts(zr[2:3], zc[2:3], [3.0]))
    assert not dp.adopt_compacted(folded, expected_version=version)
    assert dp.delta_nnz == 3
    version, r, c, v = dp.snapshot_for_compaction()
    assert dp.adopt_compacted(dp.build_compacted(r, c, v),
                              expected_version=version)
    assert dp.delta_nnz == 0 and dp.compactions == 1
    assert dp.refresh_cost_model() is False


# ---------------------------------------------------------------------------
# the facade over a dynamic plan
# ---------------------------------------------------------------------------
def test_facade_dynamic_matrix(rng):
    rows, cols, vals = _random_coo(41, 30, 34, 0.1)
    a = sp.from_coo(rows, cols, vals, (30, 34), device="cpu", dynamic=True)
    assert a.is_dynamic and not a.is_sharded
    dense = _dense(rows, cols, vals, (30, 34))
    b = rng.randn(34, 6).astype(np.float32)
    zr, zc = np.nonzero(dense == 0)
    ins = GraphDelta.inserts(zr[:4], zc[:4], [1.0, -2.0, 3.0, 0.5])
    a.plan.update(ins)
    _apply_delta_dense(dense, ins)
    assert a.nnz == rows.size + 4
    np.testing.assert_allclose(a.dense(), dense)
    _close(sp.spmm(a, b), dense @ b, TOL_DENSE)
    _close(a @ torch.from_numpy(b), dense @ b, TOL_DENSE)
    bb = np.stack([b, -b])
    _close(sp.bspmm(a, torch.from_numpy(bb))[1], dense @ -b, TOL_DENSE)
    x = rng.randn(30, 5).astype(np.float32)
    y = rng.randn(5, 34).astype(np.float32)
    for call in (lambda: sp.sddmm(a, x, y),
                 lambda: a.with_values(np.ones(a.nnz)),
                 lambda: sp.spspmm(a, a)):
        with pytest.raises(PlanBuildError, match="pending structural"):
            call()
    a.plan.compact()
    r, c, _ = a.coo()
    _close(sp.sddmm(a, x, y), (x @ y)[r, c], TOL_DENSE)
    assert not a.with_values(np.ones(a.nnz)).is_dynamic


def test_structured_base_plan_rides_the_general_payload(rng):
    """A dynamic plan over an N:M plan: the sidecar's dispatch runs on the
    general payload's signature (``general_format_sig``), reading the
    general tiles that ride beside the packed ones, as the reference's
    does; value updates of core entries demote the plan, as
    ``update_values`` does."""
    m, k = 64, 64
    g = rng.randn(m, k // 4, 4)
    keep = np.argsort(rng.rand(*g.shape), axis=-1) < 2
    w = np.where(keep, g, 0.0).reshape(m, k)
    rows, cols = np.nonzero(w)
    vals = w[rows, cols]
    kw = dict(bm=32, bk=16, structure_hint=("nm", 2, 4), alpha=1e-9,
              enable_col_stage=False)
    port = _dyn(rows, cols, vals, (m, k),
                cfg=spmm.SpmmConfig(impl="torch", **kw), auto_compact=False)
    want = JaxDynamicPlan(jax_spmm.prepare(
        rows, cols, vals, (m, k), jax_spmm.SpmmConfig(impl="xla", **kw)),
        auto_compact=False)
    assert port.plan.matrix_format == want.plan.matrix_format == "nm"
    b = rng.randn(k, 8).astype(np.float32)
    dense = _dense(rows, cols, vals, (m, k))
    zr, zc = np.nonzero(dense == 0)
    batches = [GraphDelta.inserts(zr[:6], zc[:6], rng.randn(6)),
               GraphDelta.updates(rows[:4], cols[:4], rng.randn(4))]
    for d in batches:
        port.update(d)
        want.update(_jax_delta(d))
        _apply_delta_dense(dense, d)
        _close(port.execute(torch.from_numpy(b)),
               want.execute(jnp.asarray(b)), TOL_REF)
        _check_dense(port, dense, b)
    assert port.plan.matrix_format == want.plan.matrix_format == "general"
