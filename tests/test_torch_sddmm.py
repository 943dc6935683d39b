"""repro_torch SDDMM against the JAX package, on the CPU.

- the plain versions ``ref_tile_sddmm`` / ``ref_gather_sddmm`` against
  ``repro.kernels.ref`` and, for the tile path, against the Pallas
  ``dense_tile_sddmm`` in interpret mode (the Pallas ``gather_sddmm`` does
  not run on this jax, so the gather is held against the reference's
  plain version only); the port's ``dense_tile_sddmm``, whose contract is
  the values at the plan's core slots, against the Pallas kernel's tile
  stream read at the same slots;
- the SDDMM tier rule against ``repro.core.cost_model``;
- ``build_sddmm_maps`` value for value against the reference's, on the
  port's own plan and on a plan carried over from the JAX package;
- ``execute_sddmm`` against ``repro.exec.api.execute_sddmm`` with
  ``impl="xla"`` and against fp64 ``(X @ Y)[rows, cols]``.

Inputs come from numpy seeds.  Tolerance: max |diff| <= 1e-5 *
max(1, max |ref|) (fp32 on both sides, summed in different orders).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as jax_cost_model  # noqa: E402
from repro.core import plan_ir as jax_plan_ir  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.data import graphs  # noqa: E402
from repro.exec import api as jax_api  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.sddmm import dense_tile_sddmm as pallas_tile_sddmm  # noqa: E402
from repro_torch.core import cost_model, plan_ir, spmm  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig  # noqa: E402
from repro_torch.errors import DispatchError, PlanBuildError  # noqa: E402
from repro_torch.exec import api, cache  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    plan_from_arrays, update_maps_from_arrays,
)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.core.plan_ir import fringe_row_order  # noqa: E402
from repro_torch.kernels.sddmm import (  # noqa: E402
    dense_tile_sddmm, gather_sddmm,
)
from conftest import make_sparse  # noqa: E402

TOL = 1e-5
_PORT_FIELDS = {f.name for f in dataclasses.fields(SpmmConfig)}
_MAP_FIELDS = [f.name for f in dataclasses.fields(plan_ir.UpdateMaps)]


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= TOL * scale, (err, scale)


def _carried(jplan, impl="torch"):
    """The port plan made from a JAX plan's leaves, metadata and maps."""
    leaves, _ = jplan.tree_flatten()
    cfg = {k: v for k, v in dataclasses.asdict(jplan.config).items()
           if k in _PORT_FIELDS}
    cfg["impl"] = impl
    maps = jplan.update_maps
    return plan_from_arrays(
        {n: np.asarray(x) for n, x in zip(LEAF_NAMES, leaves)},
        dict(shape=jplan.shape, config=cfg, stats=jplan.stats,
             fringe_tier=jplan.fringe_tier, fringe_bk=jplan.fringe_bk,
             matrix_format=jplan.matrix_format,
             format_params=jplan.format_params,
             update_maps=update_maps_from_arrays(
                 {n: getattr(maps, n) for n in _MAP_FIELDS})))


def _pair(rows, cols, vals, shape, **cfg):
    ours = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="torch", **cfg))
    jplan = jax_spmm.prepare(rows, cols, vals, shape,
                             jax_spmm.SpmmConfig(impl="xla", **cfg))
    return ours, jplan


# --- plain versions ----------------------------------------------------------


def _tile_inputs(seed, t, nw, nkb, bm, bk, d):
    rng = np.random.RandomState(seed)
    sw = rng.randint(0, nw, t).astype(np.int32)
    sc = rng.randint(0, nkb, t).astype(np.int32)
    xp = rng.randn(nw * bm, d).astype(np.float32)
    yp = rng.randn(d, nkb * bk).astype(np.float32)
    return sw, sc, xp, yp


@pytest.mark.parametrize("bm,bk,d,tile_chunk", [
    (8, 128, 128, None),     # the Pallas kernel's aligned shapes
    (16, 128, 40, 3),        # D below a lane width, chunked
    (32, 256, 200, 7),
])
def test_ref_tile_sddmm_matches_reference_and_pallas(bm, bk, d, tile_chunk):
    sw, sc, xp, yp = _tile_inputs(bm + d, 23, 5, 4, bm, bk, d)
    got = ref.ref_tile_sddmm(*map(torch.from_numpy, (sw, sc, xp, yp)),
                             bm, bk, tile_chunk=tile_chunk)
    want = jax_ref.ref_tile_sddmm(*map(jnp.asarray, (sw, sc, xp, yp)), bm, bk)
    _close(got, want)
    pallas = pallas_tile_sddmm(*map(jnp.asarray, (sw, sc, xp, yp)), bm=bm,
                               bk=bk, interpret=True)
    _close(got, pallas)
    # the port's dense_tile_sddmm (on CPU tensors, its plain version): the
    # Pallas stream read at the core slots, the rest of out untouched
    _slots_match_pallas(sw, sc, xp, yp, bm, bk, pallas)


# entries of out a dense_tile_sddmm call must leave as they are
_UNTOUCHED = 7.25


def _core_lin(rng, t, bm, bk, n_core, n_other):
    """(nnz,) int64 slots: n_core distinct cells of the stream (one of them
    twice, as a duplicate COO entry reads its shared slot) and n_other
    entries off the core (-1), shuffled."""
    slots = rng.choice(t * bm * bk, n_core, replace=False)
    lin = np.concatenate([slots, slots[:1], np.full(n_other, -1)])
    return lin[rng.permutation(lin.size)].astype(np.int64)


def _slots_match_pallas(sw, sc, xp, yp, bm, bk, pallas):
    rng = np.random.RandomState(bm * bk + xp.shape[1])
    t = sw.shape[0]
    lin = _core_lin(rng, t, bm, bk, min(40, t * bm * bk), 9)
    out = torch.full((lin.size,), _UNTOUCHED)
    got = dense_tile_sddmm(*map(torch.from_numpy, (sw, sc, lin, xp)),
                           torch.from_numpy(np.ascontiguousarray(yp.T)), out,
                           bm=bm, bk=bk)
    assert got is out
    core = lin >= 0
    _close(got[torch.from_numpy(core)],
            np.asarray(pallas).reshape(-1)[lin[core]])
    assert bool((got[torch.from_numpy(~core)] == _UNTOUCHED).all())


@pytest.mark.parametrize("bm,bk,d", [
    (8, 128, 7),    # D not a multiple of 4
    (16, 128, 1),
])
def test_dense_tile_sddmm_at_slots_matches_pallas(bm, bk, d):
    sw, sc, xp, yp = _tile_inputs(bm + d, 11, 4, 3, bm, bk, d)
    pallas = pallas_tile_sddmm(*map(jnp.asarray, (sw, sc, xp, yp)), bm=bm,
                               bk=bk, interpret=True)
    _slots_match_pallas(sw, sc, xp, yp, bm, bk, pallas)


def test_ref_tile_sddmm_of_an_empty_stream():
    sw, sc, xp, yp = _tile_inputs(0, 0, 2, 3, 8, 16, 5)
    out = ref.ref_tile_sddmm(*map(torch.from_numpy, (sw, sc, xp, yp)), 8, 16)
    assert out.shape == (0, 8, 16)
    # no core slot: dense_tile_sddmm leaves out as it was
    lin = torch.full((4,), -1, dtype=torch.int64)
    out = torch.full((4,), _UNTOUCHED)
    got = dense_tile_sddmm(*map(torch.from_numpy, (sw, sc)), lin,
                           torch.from_numpy(xp),
                           torch.from_numpy(np.ascontiguousarray(yp.T)), out,
                           bm=8, bk=16)
    assert bool((got == _UNTOUCHED).all())
    # and with no out it returns zeros of the COO's length
    assert torch.equal(dense_tile_sddmm(
        *map(torch.from_numpy, (sw, sc)), lin, torch.from_numpy(xp),
        torch.from_numpy(np.ascontiguousarray(yp.T)), bm=8, bk=16),
        torch.zeros(4))


@pytest.mark.parametrize("chunk", [None, 1, 64, 1000, 5000])
def test_ref_gather_sddmm_matches_reference(chunk):
    """The plain version writes each dot at its given position: read at
    those positions, it is the reference's (input order), and the
    wrapper's CPU form over the row walk of the same entries is it."""
    rng = np.random.RandomState(7)
    m, k, d, nnz = 90, 70, 33, 3001
    rows = rng.randint(0, m, nnz).astype(np.int32)
    cols = rng.randint(0, k, nnz).astype(np.int32)
    pos = rng.permutation(nnz + 5)[:nnz].astype(np.int32)
    x = rng.randn(m, d).astype(np.float32)
    yt = rng.randn(k, d).astype(np.float32)
    out = torch.full((nnz + 5,), 7.0)
    got = ref.ref_gather_sddmm(*map(torch.from_numpy, (rows, cols, pos, x,
                                                       yt)), out,
                               chunk=chunk)
    assert got is out
    want = jax_ref.ref_gather_sddmm(*map(jnp.asarray, (rows, cols, x, yt)),
                                    chunk=chunk)
    _close(got[pos], want)
    _close(got[pos], np.einsum("id,id->i", x[rows].astype(np.float64),
                               yt[cols].astype(np.float64)))
    untouched = np.setdiff1d(np.arange(nnz + 5), pos)
    assert bool((got[untouched] == 7.0).all())
    walk = fringe_row_order(*map(torch.from_numpy, (rows, cols, pos)), m)
    assert torch.equal(
        gather_sddmm(*walk, torch.from_numpy(x), torch.from_numpy(yt),
                     torch.full((nnz + 5,), 7.0)),
        ref.ref_gather_sddmm(*map(torch.from_numpy, (rows, cols, pos, x,
                                                     yt)),
                             torch.full((nnz + 5,), 7.0)))


def test_sddmm_wrappers_reject_mismatched_operands():
    lin = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of 16"):
        dense_tile_sddmm(torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), lin,
                         torch.zeros(8, 4), torch.zeros(20, 4), bm=8, bk=16)
    with pytest.raises(ValueError, match="step_col"):
        dense_tile_sddmm(torch.zeros(1, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), lin,
                         torch.zeros(8, 4), torch.zeros(16, 4), bm=8, bk=16)
    with pytest.raises(ValueError, match="out must be"):
        dense_tile_sddmm(torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), lin,
                         torch.zeros(8, 4), torch.zeros(16, 4),
                         torch.zeros(2), bm=8, bk=16)
    i32 = torch.int32
    walk = (torch.tensor([0, 1, 1, 1], dtype=i32), torch.zeros(1, dtype=i32),
            torch.zeros(1, dtype=i32))
    with pytest.raises(ValueError, match="index"):
        gather_sddmm(walk[0], torch.zeros(2, dtype=i32), walk[2],
                     torch.zeros(3, 4), torch.zeros(3, 4), torch.zeros(2))
    with pytest.raises(ValueError, match="index"):  # indptr not (M+1,)
        gather_sddmm(walk[0][:3], *walk[1:], torch.zeros(3, 4),
                     torch.zeros(3, 4), torch.zeros(2))
    with pytest.raises(ValueError, match=r"\(K, D\)"):
        gather_sddmm(*walk, torch.zeros(3, 4), torch.zeros(3, 5),
                     torch.zeros(2))
    with pytest.raises(ValueError, match="out float32"):
        gather_sddmm(*walk, torch.zeros(3, 4), torch.zeros(3, 4),
                     torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="disagree on D"):
        ops.sddmm_gather(*walk, torch.zeros(3, 4), torch.zeros(3, 5),
                         torch.zeros(2), impl="torch")
    with pytest.raises(ValueError, match="chunk"):
        ops.sddmm_gather(*walk, torch.zeros(3, 4), torch.zeros(3, 4),
                         torch.zeros(2), impl="torch", chunk=0)
    with pytest.raises(ValueError, match="does not run"):
        ops.sddmm_gather(*walk, torch.zeros(3, 4), torch.zeros(3, 4),
                         torch.zeros(2), impl="cuda")


# --- tier rule ---------------------------------------------------------------


@pytest.mark.parametrize("d,m,k,budget", [
    (16, 100, 100, None),        # fits the reference's budget
    (256, 232965, 232965, None),  # reddit scale: the reference says "xla"
    (64, 4096, 4096, 1),         # a budget nothing fits
    (64, 4096, 4096, 10 ** 9),
])
def test_sddmm_tier_rule(d, m, k, budget):
    assert cost_model.sddmm_resident_bytes(d, m, k) == \
        jax_cost_model.sddmm_resident_bytes(d, m, k)
    want = jax_cost_model.select_sddmm_tier(d, m, k, vmem_budget=budget)
    assert cost_model.select_sddmm_tier(
        d, m, k, vmem_budget=budget, impl="torch") == want
    # the H100 rule: on the card no SDDMM work falls to a plain version
    assert cost_model.select_sddmm_tier(
        d, m, k, vmem_budget=budget, impl="cuda") == "resident"


# --- maps -------------------------------------------------------------------


def _maps_equal(ours, theirs, plan):
    """``core_lin`` equal to the reference's; the walk holds exactly the
    reference's fringe subset (``f_idx``, ``f_rows``, ``f_cols``), each
    entry at its input position, sorted by row with input order kept in a
    row, its column as a row of ``plan``'s permuted Y^T panel."""
    got = ours.core_lin.numpy()
    assert np.array_equal(got, np.asarray(theirs.core_lin).astype(np.int64))
    assert ours.core_lin.dtype == torch.int64
    assert (ours.nnz, ours.nnz_f) == (theirs.nnz, theirs.nnz_f)
    indptr, cols, pos = (t.numpy().astype(np.int64) for t in ours.walk)
    f_idx = np.asarray(theirs.f_idx).astype(np.int64)
    assert np.array_equal(np.sort(pos), np.flatnonzero(f_idx >= 0))
    rows = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    sub = f_idx[pos]
    assert np.array_equal(rows, np.asarray(theirs.f_rows)[sub])
    if plan.config.reorder_cols:
        cols = plan.col_perm.numpy()[cols]
    assert np.array_equal(cols, np.asarray(theirs.f_cols)[sub])
    same_row = rows[1:] == rows[:-1]
    assert (pos[1:][same_row] > pos[:-1][same_row]).all()


@pytest.mark.parametrize("cfg", [
    dict(), dict(alpha=1.0), dict(alpha=1e-9, enable_col_stage=False),
    dict(reorder_cols=True),
])
def test_sddmm_maps_match_reference(cfg):
    rng = np.random.RandomState(11)
    _, rows, cols, vals = make_sparse(rng, 200, 900, 0.01, n_dense_rows=8)
    ours, jplan = _pair(rows, cols, vals, (200, 900), **cfg)
    theirs = jax_plan_ir.build_sddmm_maps(jplan)
    _maps_equal(plan_ir.build_sddmm_maps(ours), theirs, ours)
    carried = _carried(jplan)
    _maps_equal(plan_ir.build_sddmm_maps(carried), theirs, carried)
    # built once per plan
    assert plan_ir.build_sddmm_maps(ours) is plan_ir.build_sddmm_maps(ours)


def test_sddmm_needs_update_maps():
    rng = np.random.RandomState(1)
    _, rows, cols, vals = make_sparse(rng, 30, 30, 0.1)
    plan = dataclasses.replace(
        spmm.prepare(rows, cols, vals, (30, 30), SpmmConfig(impl="torch")),
        update_maps=None)
    with pytest.raises(PlanBuildError, match="update maps"):
        api.execute_sddmm(plan, torch.ones(30, 4), torch.ones(4, 30))


# --- execute_sddmm -----------------------------------------------------------


def _check_sddmm(rows, cols, vals, shape, d=24, batch=2, **cfg):
    rng = np.random.RandomState(shape[0] + d)
    x = rng.randn(shape[0], d).astype(np.float32)
    y = rng.randn(d, shape[1]).astype(np.float32)
    ours, jplan = _pair(rows, cols, vals, shape, **cfg)
    want = np.asarray(jax_api.execute_sddmm(jplan, jnp.asarray(x),
                                            jnp.asarray(y)))
    exact = (x.astype(np.float64) @ y.astype(np.float64))[rows, cols]
    xb = rng.randn(batch, shape[0], d).astype(np.float32)
    yb = rng.randn(batch, d, shape[1]).astype(np.float32)
    want_b = np.asarray(jax_api.execute_sddmm(jplan, jnp.asarray(xb),
                                              jnp.asarray(yb)))
    for plan in (ours, _carried(jplan)):
        got = api.execute_sddmm(plan, torch.from_numpy(x), torch.from_numpy(y))
        assert got.dtype == torch.float32
        _close(got, want)
        _close(got, exact)
        got_b = api.execute_sddmm(plan, torch.from_numpy(xb),
                                  torch.from_numpy(yb))
        _close(got_b, want_b)
        for i in range(batch):  # batched equals per-item calls
            assert torch.equal(got_b[i], api.execute_sddmm(
                plan, torch.from_numpy(xb[i]), torch.from_numpy(yb[i])))
    return ours


@pytest.mark.parametrize("name", ["cora", "ogbn-arxiv", "F1", "reddit"])
def test_execute_sddmm_matches_reference_on_panel(name):
    spec = graphs.PAPER_DATASETS[name]
    spec = dataclasses.replace(spec, m=min(spec.m, 2048),
                               k=min(spec.k, 2048))
    rows, cols, vals = graphs.generate(spec)
    plan = _check_sddmm(rows, cols, vals, (spec.m, spec.k), d=40)
    assert plan.has_core or plan.has_fringe


@pytest.mark.parametrize("cfg,paths", [
    (dict(), (True, True)),
    (dict(alpha=1.0), (False, True)),                           # all fringe
    (dict(alpha=1e-9, enable_col_stage=False), (True, False)),  # all core
    (dict(reorder_cols=True), (True, True)),
    (dict(fringe_chunk=5), (True, True)),
    (dict(bm=32, bk=16, bn=128), (True, True)),
])
def test_execute_sddmm_matches_reference_across_configs(cfg, paths):
    rng = np.random.RandomState(5)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.02, n_dense_rows=10)
    plan = _check_sddmm(rows, cols, vals, (300, 260), **cfg)
    assert (plan.has_core, plan.has_fringe) == paths


def test_execute_sddmm_with_duplicate_entries():
    """Duplicates share a tile slot (or sit twice in the fringe); each
    reads the same dot product."""
    rng = np.random.RandomState(2)
    _, rows, cols, vals = make_sparse(rng, 300, 260, 0.02, n_dense_rows=10)
    dup = rng.choice(rows.size, 200, replace=False)
    rows = np.concatenate([rows, rows[dup]])
    cols = np.concatenate([cols, cols[dup]])
    vals = np.concatenate([vals, vals[dup]])
    plan = _check_sddmm(rows, cols, vals, (300, 260))
    assert plan.has_core and plan.has_fringe


def test_execute_sddmm_on_an_empty_matrix():
    empty = np.zeros(0, np.int64)
    plan = spmm.prepare(empty, empty, np.zeros(0, np.float32), (32, 48),
                        SpmmConfig(impl="torch"))
    assert api.execute_sddmm(plan, torch.ones(32, 4),
                             torch.ones(4, 48)).shape == (0,)
    assert api.execute_sddmm(plan, torch.ones(3, 32, 4),
                             torch.ones(3, 4, 48)).shape == (3, 0)


@pytest.mark.parametrize("x_shape,y_shape,match", [
    ((30, 4), (4,), "must be"),
    ((2, 30, 4), (4, 20), "batched together"),
    ((2, 30, 4), (3, 4, 20), "batch sizes"),
    ((29, 4), (4, 20), "M=29"),
    ((30, 4), (4, 21), "K=21"),
    ((30, 4), (5, 20), "disagree on D"),
])
def test_sddmm_operand_validation_matches_reference(x_shape, y_shape, match):
    rng = np.random.RandomState(4)
    _, rows, cols, vals = make_sparse(rng, 30, 20, 0.2)
    ours, jplan = _pair(rows, cols, vals, (30, 20))
    with pytest.raises(ValueError, match=match):
        jax_api.execute_sddmm(jplan, jnp.ones(x_shape), jnp.ones(y_shape))
    with pytest.raises(ValueError, match=match):
        api.execute_sddmm(ours, torch.ones(x_shape), torch.ones(y_shape))


def test_sddmm_rejects_operands_on_another_device():
    rng = np.random.RandomState(4)
    _, rows, cols, vals = make_sparse(rng, 30, 20, 0.2)
    plan = spmm.prepare(rows, cols, vals, (30, 20), SpmmConfig(impl="torch"))
    with pytest.raises(DispatchError):
        api.execute_sddmm(plan, torch.ones(30, 4, device="meta"),
                          torch.ones(4, 20))


def test_operator_tags_and_executors_never_alias():
    """Same plan signature, another operator tag: another executor."""
    rng = np.random.RandomState(6)
    _, rows, cols, vals = make_sparse(rng, 48, 40, 0.1, n_dense_rows=3)
    plan = spmm.prepare(rows, cols, vals, (48, 40), SpmmConfig(impl="torch",
                                                                seed=77))
    sig = plan.signature()
    tagged = plan_ir.tag_op(sig, "sddmm", 1, 2, 3)
    jtagged = jax_plan_ir.tag_op(sig, "sddmm", 1, 2, 3)
    assert tagged == jtagged
    assert plan_ir.sig_op(sig) == "spmm" and plan_ir.sig_op(tagged) == "sddmm"
    assert plan_ir.op_extra(tagged) == (1, 2, 3) and plan_ir.op_extra(sig) == ()
    assert plan_ir.untag_sig(tagged) == sig and tagged != sig
    with pytest.raises(ValueError, match="plan-style"):
        plan_ir.tag_op(("delta", 1), "sddmm")
    api.execute(plan, torch.ones(40, 8))
    t0 = cache.fused_trace_count()
    x, y = torch.ones(48, 4), torch.ones(4, 40)
    api.execute_sddmm(plan, x, y)
    assert cache.fused_trace_count() - t0 == 1  # built fresh
    d0 = cache.dispatch_count()
    for _ in range(3):
        api.execute_sddmm(plan, x, y)
    assert cache.fused_trace_count() - t0 == 1  # then cached
    assert cache.dispatch_count() - d0 == 3
