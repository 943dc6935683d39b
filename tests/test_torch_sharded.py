"""The port's sharded plans (``prepare_sharded``, ``execute_sharded``)
against the JAX package's, on the CPU.

Meshes here are the CPU repeated (``make_spmm_mesh(devices=["cpu"] *
n)``), so every shard count runs in this process.  The reference's side:

- its ``prepare_sharded`` (``impl="xla"``) reads only ``axis_names`` and
  ``shape`` of a mesh, so a stand-in of n shards gives its n-way plan in
  process; the port's stacked leaves, signature (impl aside),
  ``assemble``, stats and ``ShardedUpdateMaps`` must equal it at 1, 2, 4
  and 8 shards on both axes;
- its outputs: ``execute_sharded`` on its 1-device mesh at 1 shard, and
  at n shards its own per-shard body (``repro.exec.pipeline._fused_body``
  of the per-shard signature) over each slice of its stacked leaves, then
  its assemble gather, which is what its ``shard_map`` program computes.

The port's outputs must lie within rtol = atol = 1e-5 of the reference's,
and of the fp64 dense product at n > 1 shards; with an Inf in B's row 0
(which the padding entries of every shard's fringe read) its NaN cells
must be the reference's.  The 21 tests of
``tests/test_sharded_executor.py`` are mirrored; the ones that need eight
devices and the forced-mesh subprocess panel run in process at 2, 4 and
8 shards.  Last, the padded fringe's cut row orders (B2's and B3's walks
on the card) are held bit for bit against the walk over every padding
entry, with the emulation of ``tests/test_torch_sidecar_walk.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as jax_cost_model  # noqa: E402
from repro.core import coordinator as jax_coordinator  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.data import graphs as jax_graphs  # noqa: E402
from repro.exec import execute_sharded as jax_execute_sharded  # noqa: E402
from repro.exec import pipeline as jax_pipeline  # noqa: E402
from repro.launch.mesh import make_spmm_mesh as jax_make_spmm_mesh  # noqa
from repro_torch.core import spmm  # noqa: E402
from repro_torch.core.cost_model import (  # noqa: E402
    default_cost_model, select_shard_axis,
)
from repro_torch.core.coordinator import window_costs_from_coo  # noqa: E402
from repro_torch.core.plan_ir import (  # noqa: E402
    SIG_IMPL, ShardedPlan, bucket_fringe_kblocks,
)
from repro_torch.distributed import SpmmMesh, make_spmm_mesh  # noqa: E402
from repro_torch.errors import DispatchError  # noqa: E402
from repro_torch.exec import api, cache  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gather_spmm import (  # noqa: E402
    kbucket_row_order, stream_row_order,
)
from conftest import make_sparse  # noqa: E402
from test_torch_sidecar_walk import (  # noqa: E402
    _hard_b, _row0, _same_bits, _walk_row,
)

TOL = 1e-5
CFG = spmm.SpmmConfig(impl="torch")
JCFG = jax_spmm.SpmmConfig(impl="xla")
_MAP_FIELDS = ("rows", "cols", "vals", "path", "core_lin", "fringe_pos",
               "kb_pos", "core_lin_sorted", "core_members_sorted",
               "key_sorted", "key_order")


def _mesh(n):
    return make_spmm_mesh(devices=["cpu"] * n)


def _ref_mesh(n):
    """The reference's mesh, as its ``prepare_sharded`` reads it."""
    return types.SimpleNamespace(axis_names=("data",), shape={"data": n},
                                 devices=np.empty(n, object))


def _problem(rng, m=300, k=120, density=0.08, dense_rows=6):
    return make_sparse(rng, m, k, density, n_dense_rows=dense_rows)


def _both(rows, cols, vals, shape, n, cfg=CFG, jcfg=JCFG, **kw):
    ours = spmm.prepare_sharded(rows, cols, vals, shape, _mesh(n), cfg, **kw)
    theirs = jax_spmm.prepare_sharded(rows, cols, vals, shape, _ref_mesh(n),
                                      jcfg, **kw)
    return ours, theirs


def _ref_out(jplan, b):
    """The reference's sharded result, computed as its ``shard_map``
    program does: its per-shard body on each slice of its stacked leaves
    (rows axis) or on each block of B's columns (rhs axis)."""
    body = jax_pipeline._fused_body(jplan.sig)
    b = jnp.asarray(b)
    batched = b.ndim == 3
    items = list(b) if batched else [b]
    outs = []
    for bi in items:
        if jplan.shard_axis == "rows":
            blocks = [body(*[x[s] for x in jplan.leaves], bi)
                      for s in range(jplan.n_shards)]
            outs.append(jnp.take(jnp.concatenate(blocks), jplan.assemble,
                                 axis=0))
        else:
            w = bi.shape[1] // jplan.n_shards
            outs.append(jnp.concatenate(
                [body(*jplan.leaves, bi[:, s * w:(s + 1) * w])
                 for s in range(jplan.n_shards)], axis=1))
    out = np.stack([np.asarray(o) for o in outs])
    return out if batched else out[0]


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _pad(a, n):
    """``a`` padded with zeros to length ``n``, as ``prepare_sharded`` pads
    a shard's k-bucketed stream."""
    return np.concatenate([a, np.zeros(n - a.shape[0], a.dtype)])


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_mesh_of_repeated_devices_reads_as_the_reference_mesh():
    mesh = _mesh(4)
    assert isinstance(mesh, SpmmMesh) and mesh.size == 4
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4}
    assert mesh.uniform and mesh.first == torch.device("cpu")
    assert make_spmm_mesh(devices=["cpu"], axis_name="x").shape == {"x": 1}
    with pytest.raises(ValueError, match="disagrees"):
        make_spmm_mesh(2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        # never a smaller mesh than asked for, nor a quiet CPU one
        with pytest.raises(ValueError, match="CUDA device"):
            make_spmm_mesh(4)


# ---------------------------------------------------------------------------
# leaf parity and outputs at 1, 2, 4 and 8 shards, both axes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shard_axis", ["rows", "rhs"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_leaves_and_outputs_match_reference(n, shard_axis):
    rng = np.random.RandomState(n)
    a, rows, cols, vals = _problem(rng, m=1000, k=200, dense_rows=8)
    ours, theirs = _both(rows, cols, vals, a.shape, n, shard_axis=shard_axis)
    assert isinstance(ours, ShardedPlan) and ours.n_shards == n
    assert len(ours.leaves) == len(theirs.leaves) == 17
    for i, (x, y) in enumerate(zip(ours.leaves, theirs.leaves)):
        y = np.asarray(y)
        assert x.numpy().dtype == y.dtype, i
        assert np.array_equal(x.numpy(), y), (n, shard_axis, i)
    sig = list(ours.sig)
    sig[SIG_IMPL] = "xla"
    assert tuple(sig) == theirs.sig
    assert ours.stats == theirs.stats
    assert ours.rows_per_shard == theirs.rows_per_shard
    if shard_axis == "rows":
        assert np.array_equal(ours.assemble.numpy(),
                              np.asarray(theirs.assemble))
    else:
        assert ours.assemble is None and theirs.assemble is None
    om, tm = ours.update_maps, theirs.update_maps
    for f in ("rows", "cols", "vals", "shard_of_nnz", "local_of_nnz",
              "key_sorted", "key_order"):
        assert np.array_equal(getattr(om, f), getattr(tm, f)), f
    assert len(om.shard_maps) == len(tm.shard_maps)
    for su, tu in zip(om.shard_maps, tm.shard_maps):
        for f in _MAP_FIELDS:
            assert np.array_equal(getattr(su, f), getattr(tu, f)), f
    b = rng.randn(200, 32).astype(np.float32)
    out = api.execute_sharded(ours, torch.from_numpy(b))
    if n == 1:
        want = jax_execute_sharded(
            jax_spmm.prepare_sharded(rows, cols, vals, a.shape,
                                     jax_make_spmm_mesh(1), JCFG,
                                     shard_axis=shard_axis), jnp.asarray(b))
        _close(out, want)
    else:
        _close(out, _ref_out(theirs, b))
        _close(out, a.astype(np.float64) @ b)


@pytest.mark.parametrize("shard_axis", ["rows", "rhs"])
@pytest.mark.parametrize("n", [1, 4])
def test_inf_in_b_row_0_gives_the_reference_nan_cells(n, shard_axis):
    """Padded fringe entries add 0 * B[0] to packed row 0 of every shard:
    with an Inf in B's row 0 the plain version's NaN cells are the
    reference's, and the finite ones within the tolerance."""
    rng = np.random.RandomState(11)
    a, rows, cols, vals = _problem(rng, m=700, k=150, dense_rows=5)
    ours, theirs = _both(rows, cols, vals, a.shape, n, shard_axis=shard_axis)
    b = rng.randn(150, 16).astype(np.float32)
    b[0, 3] = np.inf
    b[0, 5] = -np.inf
    got = api.execute_sharded(ours, torch.from_numpy(b)).numpy()
    want = _ref_out(theirs, b)
    assert np.isnan(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


def test_sharded_ksharded_tier_matches_reference_layout():
    """A budget that puts the mesh-uniform fringe on the k-sharded tier:
    the port's "torch" leaves equal the reference's "xla" ones (no
    k-bucketed stream on either), and the result is the dense product."""
    rng = np.random.RandomState(3)
    a, rows, cols, vals = _problem(rng, m=300, k=96, density=0.1,
                                   dense_rows=2)
    cfg = dataclasses.replace(CFG, fringe_vmem_budget=40_000)
    jcfg = dataclasses.replace(JCFG, fringe_vmem_budget=40_000)
    ours, theirs = _both(rows, cols, vals, a.shape, 4, cfg, jcfg,
                         shard_axis="rows")
    assert ours.stats_dict["fringe_tier"] == "ksharded"
    for x, y in zip(ours.leaves, theirs.leaves):
        assert np.array_equal(x.numpy(), np.asarray(y))
    b = rng.randn(96, 8).astype(np.float32)
    _close(api.execute_sharded(ours, torch.from_numpy(b)),
           a.astype(np.float64) @ b)


# ---------------------------------------------------------------------------
# tests/test_sharded_executor.py, 1-device mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shard_axis", ["rows", "rhs", "auto"])
def test_one_device_mesh_matches_execute(rng, shard_axis):
    a, rows, cols, vals = _problem(rng)
    plan = spmm.prepare(rows, cols, vals, a.shape, CFG, device="cpu")
    b = torch.from_numpy(rng.randn(a.shape[1], 32).astype(np.float32))
    ref = api.execute(plan, b)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(1), CFG,
                                 shard_axis=shard_axis)
    _close(api.execute_sharded(splan, b), ref)
    jplan = jax_spmm.prepare_sharded(rows, cols, vals, a.shape,
                                     jax_make_spmm_mesh(1), JCFG,
                                     shard_axis=shard_axis)
    _close(api.execute_sharded(splan, b),
           jax_execute_sharded(jplan, jnp.asarray(b.numpy())))


def test_one_device_mesh_batched(rng):
    a, rows, cols, vals = _problem(rng)
    plan = spmm.prepare(rows, cols, vals, a.shape, CFG, device="cpu")
    b3 = torch.from_numpy(rng.randn(4, a.shape[1], 16).astype(np.float32))
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(1), CFG,
                                 shard_axis="rows")
    out = api.execute_sharded(splan, b3)
    assert out.shape == (4, a.shape[0], 16)
    _close(out, api.execute(plan, b3))


def test_sharded_empty_matrix():
    splan = spmm.prepare_sharded(
        np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32),
        (40, 24), _mesh(1), CFG)
    out = api.execute_sharded(splan, torch.ones((24, 8)))
    assert out.shape == (40, 8) and bool((out == 0).all())


def test_sharded_rejects_mismatched_rhs_k(rng):
    a, rows, cols, vals = _problem(rng)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(1), CFG,
                                 shard_axis="rows")
    with pytest.raises(ValueError, match="does not match the plan"):
        api.execute_sharded(splan, torch.zeros((a.shape[1] - 8, 4)))


def test_sharded_rejects_reorder_cols(rng):
    a, rows, cols, vals = _problem(rng)
    with pytest.raises(ValueError, match="reorder_cols"):
        spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(1),
                             dataclasses.replace(CFG, reorder_cols=True))


def test_rhs_axis_one_shard_accepts_any_n(rng):
    a, rows, cols, vals = _problem(rng)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(1), CFG,
                                 shard_axis="rhs")
    out = api.execute_sharded(splan, torch.ones((a.shape[1], 7)))
    assert out.shape == (a.shape[0], 7)


def test_sharded_stats_record_balance(rng):
    a, rows, cols, vals = _problem(rng)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(1), CFG,
                                 shard_axis="rows")
    sd = splan.stats_dict
    assert sd["n_shards"] == 1
    assert sd["rows_imbalance"] == pytest.approx(1.0)
    assert sum(sd["shard_nnz"]) == rows.shape[0]
    assert sum(sd["shard_rows"]) == a.shape[0]


def _alternating_windows(bm=128):
    rows = np.concatenate(
        [np.full(40, w * bm + 3, np.int64) for w in range(0, 16, 2)])
    cols = np.tile(np.arange(40, dtype=np.int64), 8)
    return rows, cols, np.ones(rows.size, np.float32), (16 * bm, 64)


def test_empty_windows_spread_across_shards():
    """8 costed and 8 empty windows: every window lands somewhere, and the
    per-shard rows cover the matrix exactly."""
    rows, cols, vals, shape = _alternating_windows()
    splan = spmm.prepare_sharded(rows, cols, vals, shape, _mesh(1), CFG,
                                 shard_axis="rows")
    assert sum(splan.stats_dict["shard_rows"]) == shape[0]
    b = torch.from_numpy(
        np.random.RandomState(0).randn(64, 8).astype(np.float32))
    plan = spmm.prepare(rows, cols, vals, shape, CFG, device="cpu")
    _close(api.execute_sharded(splan, b), api.execute(plan, b))


def test_empty_windows_balance_padded_rows_in_process():
    """On an 8-way mesh: every shard gets one costed and one empty window
    (256 padded rows), not one shard nine windows."""
    rows, cols, vals, shape = _alternating_windows()
    splan = spmm.prepare_sharded(rows, cols, vals, shape, _mesh(8), CFG,
                                 shard_axis="rows")
    assert splan.stats_dict["rows_per_shard_padded"] == 2 * 128
    assert all(r == 2 * 128 for r in splan.stats_dict["shard_rows"])


# ---------------------------------------------------------------------------
# shard-axis estimator (the port's copies, against the reference's)
# ---------------------------------------------------------------------------
def test_window_costs_respect_alpha_override():
    cm = default_cost_model()
    jcm = jax_cost_model.default_cost_model()
    rows = np.arange(128, dtype=np.int64).repeat(64)
    wc_default = window_costs_from_coo(rows, 128, 128, 64, cm)
    wc_forced = window_costs_from_coo(rows, 128, 128, 64, cm, alpha=1.0)
    assert wc_default[0] == pytest.approx(cm.cost_matrix(128.0, 64))
    assert wc_forced[0] == pytest.approx(cm.cost_vector(128.0 * 64))
    assert np.array_equal(wc_forced, jax_coordinator.window_costs_from_coo(
        rows, 128, 128, 64, jcm, alpha=1.0))


def test_window_costs_route_by_alpha_boundary():
    cm = default_cost_model()
    rows = np.concatenate([
        np.zeros(1, np.int64), 128 + np.arange(128).repeat(256) % 128])
    wc = window_costs_from_coo(rows, 256, 128, 256, cm)
    assert wc.shape == (2,)
    assert wc[0] == pytest.approx(cm.cost_vector(1.0))
    assert wc[1] == pytest.approx(cm.cost_matrix(128.0, 256))
    assert np.array_equal(wc, jax_coordinator.window_costs_from_coo(
        rows, 256, 128, 256, jax_cost_model.default_cost_model()))


def _same_decision(wc, n):
    ours = select_shard_axis(wc, n)
    theirs = jax_cost_model.select_shard_axis(wc, n)
    assert (ours.shard_axis, ours.rows_imbalance) == (
        theirs.shard_axis, theirs.rows_imbalance)
    return ours


def test_select_shard_axis_prefers_rows_when_balanced():
    d = _same_decision(np.ones(64), 8)
    assert d.shard_axis == "rows"
    assert d.rows_imbalance == pytest.approx(1.0)


def test_select_shard_axis_falls_to_rhs_on_skew():
    wc = np.ones(8)
    wc[0] = 100.0
    d = _same_decision(wc, 8)
    assert d.shard_axis == "rhs" and d.rows_imbalance > 1.25


def test_select_shard_axis_falls_to_rhs_when_too_few_windows():
    assert _same_decision(np.ones(3), 8).shard_axis == "rhs"


def test_select_shard_axis_single_shard_and_empty():
    assert _same_decision(np.ones(4), 1).shard_axis == "rows"
    assert _same_decision(np.zeros(4), 8).shard_axis == "rows"


# ---------------------------------------------------------------------------
# signature / cache identity
# ---------------------------------------------------------------------------
def test_sharded_signature_never_aliases_plan_signature(rng):
    a, rows, cols, vals = _problem(rng)
    plan = spmm.prepare(rows, cols, vals, a.shape, CFG, device="cpu")
    mesh = _mesh(1)
    srows = spmm.prepare_sharded(rows, cols, vals, a.shape, mesh, CFG,
                                 shard_axis="rows")
    srhs = spmm.prepare_sharded(rows, cols, vals, a.shape, mesh, CFG,
                                shard_axis="rhs")
    assert len({plan.signature(), srows.signature(),
                srhs.signature()}) == 3


def test_sharded_executor_traces_once_per_structure(rng):
    a, rows, cols, vals = _problem(rng)
    mesh = _mesh(1)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, mesh, CFG,
                                 shard_axis="rows")
    b = torch.from_numpy(rng.randn(a.shape[1], 24).astype(np.float32))
    api.execute_sharded(splan, b)
    before = cache.sharded_trace_count()
    api.execute_sharded(splan, b)
    splan2 = spmm.prepare_sharded(rows, cols, vals, a.shape, mesh, CFG,
                                  shard_axis="rows")
    assert splan2.sig == splan.sig
    api.execute_sharded(splan2, b)
    assert cache.sharded_trace_count() == before


# ---------------------------------------------------------------------------
# multi-shard, in process (the reference's needs8 tests)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_multi_device_parity_in_process(rng, n_shards):
    a, rows, cols, vals = _problem(rng, m=1000, k=200, dense_rows=8)
    plan = spmm.prepare(rows, cols, vals, a.shape, CFG, device="cpu")
    b = torch.from_numpy(rng.randn(a.shape[1], 32).astype(np.float32))
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(n_shards),
                                 CFG, shard_axis="rows")
    _close(api.execute_sharded(splan, b), api.execute(plan, b))


def test_multi_device_empty_shard_in_process(rng):
    a, rows, cols, vals = _problem(rng, m=100, k=64, dense_rows=2)
    plan = spmm.prepare(rows, cols, vals, a.shape, CFG, device="cpu")
    b = torch.from_numpy(rng.randn(64, 16).astype(np.float32))
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(2), CFG,
                                 shard_axis="rows")
    assert 0 in splan.stats_dict["shard_rows"]
    _close(api.execute_sharded(splan, b), api.execute(plan, b))


def test_rhs_axis_rejects_indivisible_n_in_process(rng):
    a, rows, cols, vals = _problem(rng)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(4), CFG,
                                 shard_axis="rhs")
    with pytest.raises(ValueError, match="divisible"):
        api.execute_sharded(splan, torch.ones((a.shape[1], 30)))


def _synthetic(rng, m, k, density=0.08, dense_rows=0):
    a, rows, cols, vals = make_sparse(rng, m, k, density,
                                      n_dense_rows=dense_rows)
    return rows, cols, vals, (m, k)


def _dataset(name, max_dim=512):
    spec = jax_graphs.PAPER_DATASETS[name]
    spec = dataclasses.replace(spec, m=min(spec.m, max_dim),
                               k=min(spec.k, max_dim))
    rows, cols, vals = jax_graphs.generate(spec)
    return rows, cols, vals, (spec.m, spec.k)


def test_forced_mesh_parity_panel_in_process():
    """The reference's subprocess panel (``tests/_sharded_parity_worker``)
    on CPU meshes of 1/2/3/4/8 shards: mesh sizes, uneven windows, an
    empty shard, the rhs axis, the k-sharded tier's budget, batched
    operands on both axes, an indivisible N, and the dataset panel; each
    against the single-device ``execute`` and the reference's sharded
    result (1e-5)."""
    rng = np.random.RandomState(0)

    def check(rows, cols, vals, shape, n, shard_axis="rows", budget=None,
              batch=None, width=32):
        cfg = dataclasses.replace(CFG, fringe_vmem_budget=budget)
        jcfg = dataclasses.replace(JCFG, fringe_vmem_budget=budget)
        r = np.random.RandomState(7)
        bshape = (shape[1], width) if batch is None else (batch, shape[1],
                                                          width)
        b = r.randn(*bshape).astype(np.float32)
        plan = spmm.prepare(rows, cols, vals, shape, cfg, device="cpu")
        ours, theirs = _both(rows, cols, vals, shape, n, cfg, jcfg,
                             shard_axis=shard_axis)
        out = api.execute_sharded(ours, torch.from_numpy(b))
        _close(out, api.execute(plan, torch.from_numpy(b)))
        _close(out, _ref_out(theirs, b))

    rows, cols, vals, shape = _synthetic(rng, 1000, 200, dense_rows=8)
    for n in (1, 2, 4, 8):
        check(rows, cols, vals, shape, n)
    check(rows, cols, vals, shape, 3)
    check(*_synthetic(rng, 100, 64), 2)
    check(rows, cols, vals, shape, 4, shard_axis="rhs")
    r3 = _synthetic(rng, 300, 96)
    check(*r3, 4)
    check(*r3, 4, budget=40_000)
    check(rows, cols, vals, shape, 8, batch=3)
    check(rows, cols, vals, shape, 8, shard_axis="rhs", batch=3)
    splan = spmm.prepare_sharded(rows, cols, vals, shape, _mesh(4), CFG,
                                 shard_axis="rhs")
    with pytest.raises(DispatchError, match="divisible"):
        api.execute_sharded(splan, torch.ones((shape[1], 30)))
    for name in ("cora", "F1", "reddit"):
        check(*_dataset(name), 8)


def test_operand_must_be_on_the_mesh_first_device(rng):
    a, rows, cols, vals = _problem(rng)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(2), CFG)
    assert splan.device == torch.device("cpu")
    b = torch.ones((a.shape[1], 4), device="meta")
    with pytest.raises(DispatchError, match="first device"):
        api.execute_sharded(splan, b)


def test_shards_view_one_stack_on_a_uniform_mesh(rng):
    """Shards on one device read views of the stacked leaves (one upload),
    each with its own ``derived`` and flag; a value update copies the
    leaves it writes, the old plan keeps its values, and the new plan
    keeps each shard's ``derived``."""
    a, rows, cols, vals = _problem(rng, m=600, k=100, dense_rows=6)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(4), CFG,
                                 shard_axis="rows")
    stack = splan.stacked[2]
    for s, sh in enumerate(splan.shards):
        assert sh.leaves[2].data_ptr() == stack[s].data_ptr()
        assert sh.derived is not splan.shards[0].derived or s == 0
        assert set(sh.derived["stack_padding"]) == {"steps", "fringe", "kb"}
    from repro_torch.core.values import update_values
    old = [x.clone() for x in splan.leaves]
    idx = np.arange(0, rows.size, 7)
    new = update_values(splan, idx, np.full(idx.size, 2.5))
    for x, y in zip(splan.leaves, old):
        assert torch.equal(x, y)
    assert new.stacked is None
    for s, sh in enumerate(new.shards):
        assert sh.leaves[2].data_ptr() != stack[s].data_ptr()
        assert sh.derived is splan.shards[s].derived


# ---------------------------------------------------------------------------
# the card's walk over a shard's padded fringe (emulated)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", ["resident", "ksharded"])
def test_padded_fringe_row_order_keeps_every_bit(tier):
    """Each shard's fringe is padded with (row 0, col 0, 0.0) entries past
    its own (``stack_padding``); the row order the card walks it in keeps
    a few of them, and the walk of packed row 0 is bit for bit the walk
    over all of them, with an Inf in B's row 0 too.  On the k-sharded
    tier the shards' streams are bucketed and padded as ``prepare_sharded``
    does for ``"cuda"``."""
    rng = np.random.RandomState(13)
    a, rows, cols, vals = _problem(rng, m=900, k=640, density=0.02,
                                   dense_rows=3)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(4), CFG,
                                 shard_axis="rows")
    fr_all, fc_all, fv_all = (x for x in splan.leaves[3:6])
    nr = splan.sig[11]
    lengths = [sh.derived["stack_padding"]["fringe"] for sh in splan.shards]
    assert min(lengths) < fr_all.shape[1]   # some shard is padded
    bk = 128
    streams = []
    for s in range(4):
        own = lengths[s]
        fr, fc, fv = fr_all[s], fc_all[s], fv_all[s]
        if tier == "resident":
            streams.append((stream_row_order(fr, fc, nr), own, fv))
        else:
            kb = bucket_fringe_kblocks(fr[:own].numpy(), fc[:own].numpy(),
                                       fv[:own].numpy(), 640, bk, 8)
            streams.append(kb[:4])
    if tier == "ksharded":
        nch = max(kb[0].shape[0] for kb in streams)
        nnz = max(kb[1].shape[0] for kb in streams)
        padded = []
        for kbc, kbr, kbcol, kbv in streams:
            own = kbr.shape[0]
            kbc, kbr, kbcol, kbv = (torch.from_numpy(_pad(x, n))
                                    for x, n in ((kbc, nch), (kbr, nnz),
                                                 (kbcol, nnz), (kbv, nnz)))
            padded.append((kbucket_row_order(kbc, kbr, kbcol, nr, bk), own,
                           kbv))
        streams = padded
    cut_some = False
    for full, own, v in streams:
        cut = ops._padded_row_order(full, own)
        end_full, end_cut = int(full.indptr[1]), int(cut.indptr[1])
        cut_some |= end_cut < end_full
        assert torch.equal(cut.perm[end_cut:], full.perm[end_full:])
        assert torch.equal(cut.indptr[1:] - end_cut,
                           full.indptr[1:] - end_full)
        for inf in (False, True):
            b = _hard_b(rng, 640, 12, inf_rows=(0,) if inf else ())
            _same_bits(_walk_row(*_row0(cut, v), b),
                       _walk_row(*_row0(full, v), b))
    assert cut_some
