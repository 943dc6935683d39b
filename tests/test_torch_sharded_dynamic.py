"""The port's sharded dynamic layer, registry entries, checkpoint restore,
operator family and facade against the JAX package's, on the CPU.

Each of the reference's sharded tests below runs on both packages from
one seed: the reference on its 1-device mesh (``impl="xla"``), the port
on a CPU mesh (``impl="torch"``), both held to the fp64 dense product or
to a fresh ``prepare_sharded`` as the reference's test holds it, and to
each other (1e-5 * max(1, max|ref|)):

- ``tests/test_dynamic.py``: the sharded value update against a
  re-prepare (leaves bit-equal, results bit-equal), structural deltas and
  a compaction that stays sharded, and the forced-mesh worker
  (``tests/_dynamic_sharded_worker.py``) in process at 2 and 4 shards:
  one dispatch with the routed sidecar, bit-equal to the base dispatch
  plus ``execute_delta_contribution``;
- ``tests/test_dynamic_registry.py``: the four sharded-entry tests;
- ``tests/test_checkpoint.py::test_elastic_restore_resharded``;
- ``tests/test_operator_family.py``: the sharded SDDMM and spspmm tests,
  and its forced-mesh worker in process;
- the sharded cases of ``tests/test_cache_correctness.py``.

Then the facade: ``from_coo(mesh=)`` through every operator.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint.checkpoint as jax_ck  # noqa: E402
import repro.sparse as jax_sp  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.dynamic import DynamicPlan as JaxDynamicPlan  # noqa: E402
from repro.dynamic import GraphDelta as JaxGraphDelta  # noqa: E402
from repro.dynamic import PlanRegistry as JaxPlanRegistry  # noqa: E402
from repro.dynamic import update_values as jax_update_values  # noqa: E402
from repro.exec import api as jax_api  # noqa: E402
from repro.launch.mesh import make_spmm_mesh as jax_make_spmm_mesh  # noqa

import repro_torch.checkpoint.checkpoint as ck  # noqa: E402
import repro_torch.sparse as sp  # noqa: E402
from repro_torch.core import spmm  # noqa: E402
from repro_torch.core.plan_ir import (  # noqa: E402
    ShardedDeltaFringe, ShardedPlan, build_delta_fringe,
)
from repro_torch.distributed import make_spmm_mesh  # noqa: E402
from repro_torch.dynamic import (  # noqa: E402
    DynamicPlan, GraphDelta, PlanRegistry, update_values,
)
from repro_torch.errors import PlanBuildError, RegistryError  # noqa: E402
from repro_torch.exec import api, cache  # noqa: E402
from conftest import make_sparse  # noqa: E402

TOL = 1e-5

PORT = types.SimpleNamespace(
    name="port", spmm=spmm, impl="torch", api=api,
    DynamicPlan=DynamicPlan, GraphDelta=GraphDelta,
    PlanRegistry=PlanRegistry, update_values=update_values,
    mesh=lambda n=1: make_spmm_mesh(devices=["cpu"] * n),
    operand=torch.from_numpy,
)
REF = types.SimpleNamespace(
    name="ref", spmm=jax_spmm, impl="xla", api=jax_api,
    DynamicPlan=JaxDynamicPlan, GraphDelta=JaxGraphDelta,
    PlanRegistry=JaxPlanRegistry, update_values=jax_update_values,
    mesh=jax_make_spmm_mesh, operand=jnp.asarray,
)


def _cfg(p, **kw):
    return p.spmm.SpmmConfig(impl=p.impl, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(ours, theirs):
    ours, theirs = _np(ours), _np(theirs)
    tol = TOL * max(1.0, float(np.abs(theirs).max()) if theirs.size else 1.0)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol)


def _both(scenario, *args):
    """``scenario(p, rng, *args)`` on the port and the reference from one
    seed; the outputs (a list) must agree."""
    outs = []
    for p in (PORT, REF):
        outs.append(scenario(p, np.random.RandomState(0), *args) or [])
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        _agree(a, b)


def _random_coo(seed, m, k, density):
    rng = np.random.RandomState(seed)
    rows, cols = np.nonzero(rng.rand(m, k) < density)
    return rows.astype(np.int64), cols.astype(np.int64), rng.randn(rows.size)


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape, np.float64)
    np.add.at(a, (rows, cols), np.asarray(vals, np.float64))
    return a


def _apply_delta_dense(dense, delta):
    for r, c, v in zip(delta.ins_rows, delta.ins_cols, delta.ins_vals):
        dense[r, c] += v
    for r, c in zip(delta.del_rows, delta.del_cols):
        dense[r, c] = 0.0
    for r, c, v in zip(delta.upd_rows, delta.upd_cols, delta.upd_vals):
        dense[r, c] = v


def _check_against_dense(dp, dense, b, tol=1e-4):
    out = _np(dp.execute(b))
    expect = dense @ _np(b).astype(np.float64)
    scale = np.abs(expect).max() + 1e-9
    assert np.abs(out - expect).max() / scale < tol
    return out


# ---------------------------------------------------------------------------
# tests/test_dynamic.py
# ---------------------------------------------------------------------------
def test_sharded_value_update_matches_reprepare():
    def scenario(p, rng):
        rows, cols, vals = _random_coo(23, 70, 50, 0.1)
        mesh = p.mesh(1)
        outs = []
        for axis in ("rows", "rhs"):
            splan = p.spmm.prepare_sharded(rows, cols, vals, (70, 50), mesh,
                                           _cfg(p), shard_axis=axis)
            idx = rng.choice(rows.size, 14, replace=False)
            nv = rng.randn(14)
            updated = p.update_values(splan, idx, nv)
            vals2 = vals.copy()
            vals2[idx] = nv
            ref = p.spmm.prepare_sharded(rows, cols, vals2, (70, 50), mesh,
                                         _cfg(p), shard_axis=axis)
            for i, (got, want) in enumerate(zip(updated.leaves, ref.leaves)):
                assert np.array_equal(_np(got), _np(want)), (axis, i)
            b = p.operand(rng.randn(50, 16).astype(np.float32))
            out = p.api.execute_sharded(updated, b)
            assert np.array_equal(_np(out),
                                  _np(p.api.execute_sharded(ref, b)))
            outs += [out] + [_np(x) for x in updated.leaves]
        return outs

    _both(scenario)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", ["rows", "rhs"])
def test_sharded_value_update_matches_reprepare_multi_shard(n, axis):
    """The port at n shards: updated leaves bit-equal to a re-prepare, and
    equal to the reference's (its stand-in mesh of n shards)."""
    rng = np.random.RandomState(n)
    m, k = 96 * n // 2, 64
    rows, cols, vals = _random_coo(n, m, k, 0.08)
    splan = spmm.prepare_sharded(rows, cols, vals, (m, k), PORT.mesh(n),
                                 _cfg(PORT), shard_axis=axis)
    idx = rng.choice(rows.size, 25, replace=False)
    nv = rng.randn(25)
    updated = update_values(splan, idx, nv)
    vals2 = vals.copy()
    vals2[idx] = nv
    ref = spmm.prepare_sharded(rows, cols, vals2, (m, k), PORT.mesh(n),
                               _cfg(PORT), shard_axis=axis)
    stand_in = types.SimpleNamespace(axis_names=("data",), shape={"data": n},
                                     devices=np.empty(n, object))
    theirs = jax_update_values(
        jax_spmm.prepare_sharded(rows, cols, vals, (m, k), stand_in,
                                 _cfg(REF), shard_axis=axis), idx, nv)
    for got, want, jax_leaf in zip(updated.leaves, ref.leaves,
                                   theirs.leaves):
        assert torch.equal(got, want)
        assert np.array_equal(got.numpy(), np.asarray(jax_leaf))
    for sh, rsh in zip(updated.shards, ref.shards):
        assert torch.equal(sh.a_unsplittable, rsh.a_unsplittable)
    b = torch.from_numpy(rng.randn(k, 16).astype(np.float32))
    assert torch.equal(api.execute_sharded(updated, b),
                       api.execute_sharded(ref, b))


def test_sharded_structural_and_compact():
    def scenario(p, rng):
        rows, cols, vals = _random_coo(29, 64, 48, 0.1)
        splan = p.spmm.prepare_sharded(rows, cols, vals, (64, 48), p.mesh(1),
                                       _cfg(p), shard_axis="rows")
        dp = p.DynamicPlan(splan, auto_compact=False)
        assert dp.is_sharded
        dense = _dense(rows, cols, vals, (64, 48))
        b = p.operand(rng.randn(48, 12).astype(np.float32))
        zr, zc = np.nonzero(dense == 0)
        pick = rng.choice(zr.size, 10, replace=False)
        ins = p.GraphDelta.inserts(zr[pick], zc[pick], rng.randn(10))
        dp.update(ins)
        _apply_delta_dense(dense, ins)
        dpick = rng.choice(rows.size, 6, replace=False)
        dele = p.GraphDelta.deletes(rows[dpick], cols[dpick])
        dp.update(dele)
        _apply_delta_dense(dense, dele)
        before = _check_against_dense(dp, dense, b)
        dp.compact()
        assert isinstance(dp.plan, p.spmm.ShardedPlan)  # stays sharded
        assert dp.delta_nnz == 0
        return [before, _check_against_dense(dp, dense, b)]

    _both(scenario)


@pytest.mark.parametrize("axis", ["rows", "rhs"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_dynamic_parity_worker_in_process(n_shards, axis):
    """``tests/_dynamic_sharded_worker.py`` at 2 and 4 CPU shards (and on
    the rhs axis beside it): value parity bit for bit, structural deltas
    against the dense product before and after a compaction that keeps
    the mesh, and sharded + delta as one dispatch, bit-equal to the base
    dispatch plus the sidecar's contribution on its own."""
    rng = np.random.RandomState(n_shards)
    m, k = 96 * n_shards // 2, 64
    rows, cols, vals = _random_coo(n_shards, m, k, 0.08)
    mesh = PORT.mesh(n_shards)
    cfg = _cfg(PORT)
    b = torch.from_numpy(rng.randn(k, 16).astype(np.float32))
    splan = spmm.prepare_sharded(rows, cols, vals, (m, k), mesh, cfg,
                                 shard_axis=axis)
    idx = rng.choice(rows.size, 25, replace=False)
    nv = rng.randn(25)
    updated = update_values(splan, idx, nv)
    vals2 = vals.copy()
    vals2[idx] = nv

    dp = DynamicPlan(updated, auto_compact=False)
    dense = _dense(rows, cols, vals2, (m, k))
    zr, zc = np.nonzero(dense == 0)
    pick = rng.choice(zr.size, 18, replace=False)
    iv = rng.randn(18)
    dp.update(GraphDelta.inserts(zr[pick], zc[pick], iv))
    dense[zr[pick], zc[pick]] += iv
    dpick = rng.choice(rows.size, 9, replace=False)
    dp.update(GraphDelta.deletes(rows[dpick], cols[dpick]))
    dense[rows[dpick], cols[dpick]] = 0
    _check_against_dense(dp, dense, b)

    delta = dp._materialize()
    assert isinstance(delta, ShardedDeltaFringe) == (axis == "rows")
    if axis == "rows":
        assert len(delta.shards) == n_shards
        assert all(df.derived is not delta.shards[0].derived
                   for df in delta.shards[1:])
    before = cache.dispatch_count()
    fused = dp.execute(b)
    assert cache.dispatch_count() - before == 1
    keys = np.fromiter(dp._overlay, np.int64, count=len(dp._overlay))
    targets = [dp._overlay[int(key)] for key in keys]
    base_sums = dp._base_key_sums(keys)
    in_base = dp.maps.lookup(keys // k, keys % k) >= 0
    dvals = np.array([
        (-base_sums[i] if t is None
         else (t - base_sums[i] if in_base[i] else t))
        for i, t in enumerate(targets)], np.float64)
    plain = build_delta_fringe(keys // k, keys % k, dvals, (m, k), cfg,
                               device="cpu")
    legacy = api.execute_sharded(dp.plan, b) + api.execute_delta_contribution(
        (m, k), cfg, plain, b)
    assert torch.equal(fused, legacy)

    dp.compact()
    assert isinstance(dp.plan, ShardedPlan)
    assert dp.plan.n_shards == n_shards and dp.plan.mesh == mesh
    assert dp.plan.shard_axis == axis and dp.delta_nnz == 0
    _check_against_dense(dp, dense, b)


def test_sharded_delta_routing_needs_a_rows_plan():
    rows, cols, vals = _random_coo(3, 64, 48, 0.1)
    mesh = PORT.mesh(2)
    rhs = spmm.prepare_sharded(rows, cols, vals, (64, 48), mesh, _cfg(PORT),
                               shard_axis="rhs")
    rplan = spmm.prepare_sharded(rows, cols, vals, (64, 48), mesh,
                                 _cfg(PORT), shard_axis="rows")
    from repro_torch.core.plan_ir import build_sharded_delta_fringe
    with pytest.raises(ValueError, match="rows-sharded"):
        build_sharded_delta_fringe(rows[:2], cols[:2], vals[:2], rhs)
    routed = build_sharded_delta_fringe(np.array([1]), np.array([2]),
                                        np.array([1.0]), rplan)
    plain = build_delta_fringe(np.array([1]), np.array([2]), np.array([1.0]),
                               (64, 48), _cfg(PORT), device="cpu")
    b = torch.ones((48, 4))
    with pytest.raises(ValueError, match="routed"):
        api.execute_sharded(rplan, b, delta=plain)
    with pytest.raises(ValueError, match="replicates"):
        api.execute_sharded(rhs, b, delta=routed)


# ---------------------------------------------------------------------------
# tests/test_dynamic_registry.py
# ---------------------------------------------------------------------------
def _graph(rng, m=80, k=64):
    return make_sparse(rng, m, k, 0.08, n_dense_rows=3)


def _entry_dir(root, name):
    d = os.path.join(root, name)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    return os.path.join(d, steps[-1])


def _sharded_dplan(p, rows, cols, vals, shape, shard_axis="rows", n=1):
    splan = p.spmm.prepare_sharded(rows, cols, vals, shape, p.mesh(n),
                                   _cfg(p), shard_axis=shard_axis)
    return p.DynamicPlan(splan, auto_compact=False)


def _rel(out, dense, b):
    expect = dense @ _np(b).astype(np.float64)
    return np.abs(_np(out) - expect).max() / (np.abs(expect).max() + 1e-9)


def test_sharded_plan_round_trips_by_resharding(tmp_path):
    def scenario(p, rng):
        a, rows, cols, vals = _graph(rng)
        reg = p.PlanRegistry(str(tmp_path / p.name))
        dp = _sharded_dplan(p, rows, cols, vals, a.shape)
        dense = a.astype(np.float64).copy()
        dp.update(p.GraphDelta.updates(rows[:3], cols[:3],
                                       [5.0, -1.5, 2.25]))
        dense[rows[:3], cols[:3]] = [5.0, -1.5, 2.25]
        zr, zc = np.nonzero(dense == 0)
        dp.update(p.GraphDelta.inserts(zr[:4], zc[:4], [1.0, 2.0, 3.0, 4.0]))
        dense[zr[:4], zc[:4]] += [1.0, 2.0, 3.0, 4.0]
        reg.save("g", dp)
        restored = reg.load("g")  # no mesh: rebuilt at the stored count
        assert restored.is_sharded
        assert restored.plan.n_shards == 1
        assert restored.delta_nnz == dp.delta_nnz
        b = p.operand(rng.randn(a.shape[1], 8).astype(np.float32))
        out = restored.execute(b)
        assert _rel(out, dense, b) < 1e-4
        return [out]

    _both(scenario)


def test_sharded_entry_restores_onto_a_four_way_mesh(tmp_path):
    """The port alone: an entry written at 4 shards loads at its stored
    count and onto a caller's mesh, state intact and results bit-equal."""
    rng = np.random.RandomState(9)
    a, rows, cols, vals = _graph(rng, m=400, k=64)
    reg = PlanRegistry(str(tmp_path))
    dp = _sharded_dplan(PORT, rows, cols, vals, a.shape, n=4)
    zr, zc = np.nonzero(a == 0)
    dp.update(GraphDelta.inserts(zr[:6], zc[:6], np.arange(6.0)))
    reg.save("g", dp)
    b = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    want = dp.execute(b)
    for mesh in (None, PORT.mesh(4)):
        got = reg.load("g", mesh=mesh)
        assert got.plan.n_shards == 4 and got.delta_nnz == 6
        assert torch.equal(got.execute(b), want)


def test_sharded_truncated_shard_raises_then_falls_back(tmp_path):
    def scenario(p, rng):
        a, rows, cols, vals = _graph(rng)
        reg = p.PlanRegistry(str(tmp_path / p.name))
        reg.save("g", _sharded_dplan(p, rows, cols, vals, a.shape))
        victim = os.path.join(_entry_dir(str(tmp_path / p.name), "g"),
                              "coo_vals.s0.npy")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        with pytest.raises(Exception, match="corrupt|truncated") as err:
            reg.load("g")
        assert type(err.value).__name__ == "RegistryError"
        dp = reg.load_or_prepare_sharded("g", rows, cols, vals, a.shape,
                                         p.mesh(1), _cfg(p),
                                         shard_axis="rows")
        b = p.operand(rng.randn(a.shape[1], 8).astype(np.float32))
        out = dp.execute(b)
        assert _rel(out, a.astype(np.float64), b) < 1e-4
        return [out]

    _both(scenario)


def test_sharded_manifest_and_version_corruption(tmp_path):
    def scenario(p, rng):
        a, rows, cols, vals = _graph(rng)
        root = str(tmp_path / p.name)
        reg = p.PlanRegistry(root)
        reg.save("g", _sharded_dplan(p, rows, cols, vals, a.shape))
        mpath = os.path.join(_entry_dir(root, "g"), "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["meta"]["plan_format_version"] = -1
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        with pytest.raises(Exception, match="plan format"):
            reg.load("g")
        with open(mpath, "w") as f:
            f.write("{not json")
        with pytest.raises(Exception, match="manifest") as err:
            reg.load("g")
        assert type(err.value).__name__ == "RegistryError"

    _both(scenario)


def test_sharded_warm_start_matches_fingerprint(tmp_path):
    def scenario(p, rng):
        a, rows, cols, vals = _graph(rng)
        reg = p.PlanRegistry(str(tmp_path / p.name))
        mesh = p.mesh(1)
        dp = reg.load_or_prepare_sharded("g", rows, cols, vals, a.shape,
                                         mesh, _cfg(p), shard_axis="rows")
        dense = a.astype(np.float64).copy()
        zr, zc = np.nonzero(dense == 0)
        dp.update(p.GraphDelta.inserts(zr[:2], zc[:2], [7.0, -3.0]))
        dense[zr[:2], zc[:2]] += [7.0, -3.0]
        reg.save("g", dp)
        er, ec, ev = dp.to_coo()
        warm = reg.load_or_prepare_sharded("g", er, ec, ev, a.shape, mesh,
                                           _cfg(p), shard_axis="rows")
        assert warm.delta_nnz == 2
        b = p.operand(rng.randn(a.shape[1], 8).astype(np.float32))
        out = warm.execute(b)
        assert _rel(out, dense, b) < 1e-4
        vals2 = vals.copy()
        vals2[0] += 1.0
        cold = reg.load_or_prepare_sharded("g2", rows, cols, vals2, a.shape,
                                           mesh, _cfg(p), shard_axis="rows")
        assert cold.delta_nnz == 0
        return [out]

    _both(scenario)


def test_sharded_entry_crosses_packages(tmp_path):
    """A sharded entry written by the reference loads in the port (impl
    named), re-sharded onto a 2-way CPU mesh, overlay intact."""
    rng = np.random.RandomState(4)
    a, rows, cols, vals = _graph(rng)
    jdp = _sharded_dplan(REF, rows, cols, vals, a.shape)
    zr, zc = np.nonzero(a == 0)
    jdp.update(JaxGraphDelta.inserts(zr[:3], zc[:3], [1.0, 2.0, 3.0]))
    JaxPlanRegistry(str(tmp_path)).save("g", jdp)
    reg = PlanRegistry(str(tmp_path))
    with pytest.raises(RegistryError, match="impl"):
        reg.load("g")
    dp = reg.load("g", impl="torch", mesh=PORT.mesh(2))
    assert dp.is_sharded and dp.plan.n_shards == 2 and dp.delta_nnz == 3
    b = rng.randn(64, 8).astype(np.float32)
    _agree(dp.execute(torch.from_numpy(b)), jdp.execute(jnp.asarray(b)))


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"a": {"w": rng.randn(4, 3).astype(np.float32),
                  "b": np.arange(5, dtype=np.int32)},
            "c": [rng.randn(6).astype(np.float32)]}


def test_elastic_restore_resharded(tmp_path):
    rng = np.random.RandomState(0)
    t = _tree(rng)
    ck.save(str(tmp_path / "port"), 3, t)
    devices = {"a": {"w": "cpu", "b": torch.device("cpu")}, "c": ["cpu"]}
    step, restored = ck.restore_resharded(str(tmp_path / "port"), t, devices)
    assert step == 3
    assert isinstance(restored["a"]["w"], torch.Tensor)
    assert restored["a"]["w"].device == torch.device("cpu")
    jt = jax.tree.map(jnp.asarray, t)
    jax_ck.save(str(tmp_path / "ref"), 3, jt)
    dev = jax.devices()[0]
    jstep, jrestored = jax_ck.restore_resharded(
        str(tmp_path / "ref"), jt,
        jax.tree.map(lambda _: jax.sharding.SingleDeviceSharding(dev), jt))
    assert jstep == step
    for x, y, z in zip(jax.tree.leaves(t), ck._leaf_paths(restored),
                       jax.tree.leaves(jrestored)):
        assert np.array_equal(y[1].numpy(), x)
        assert np.array_equal(y[1].numpy(), np.asarray(z))
    # either package reads what the other wrote
    _, cross = ck.restore_resharded(str(tmp_path / "ref"), t, devices)
    assert np.array_equal(cross["c"][0].numpy(), t["c"][0])


# ---------------------------------------------------------------------------
# tests/test_operator_family.py
# ---------------------------------------------------------------------------
def _coo(rng, m, k, nnz):
    rows = rng.randint(0, m, nnz).astype(np.int64)
    cols = rng.randint(0, k, nnz).astype(np.int64)
    return rows, cols, rng.randn(nnz)


def test_sddmm_sharded_matches_single_device():
    def scenario(p, rng):
        m, k, d = 96, 64, 12
        rows, cols, vals = _coo(rng, m, k, 400)
        cfg = _cfg(p)
        plan = (spmm.prepare(rows, cols, vals, (m, k), cfg, device="cpu")
                if p is PORT else jax_spmm.prepare(rows, cols, vals, (m, k),
                                                   cfg))
        splan = p.spmm.prepare_sharded(rows, cols, vals, (m, k), p.mesh(1),
                                       cfg)
        x = p.operand(rng.randn(m, d).astype(np.float32))
        y = p.operand(rng.randn(d, k).astype(np.float32))
        out = p.api.execute_sddmm(splan, x, y)
        _agree(out, p.api.execute_sddmm(plan, x, y))
        xb = p.operand(rng.randn(2, m, d).astype(np.float32))
        yb = p.operand(rng.randn(2, d, k).astype(np.float32))
        outb = p.api.execute_sddmm(splan, xb, yb)
        _agree(outb, p.api.execute_sddmm(plan, xb, yb))
        return [out, outb]

    _both(scenario)


def test_spspmm_sharded_inputs():
    def scenario(p, rng):
        m, k, n = 80, 64, 48
        ar, ac, av = _coo(rng, m, k, 300)
        br, bc, bv = _coo(rng, k, n, 250)
        cfg = _cfg(p)
        sa = p.spmm.prepare_sharded(ar, ac, av, (m, k), p.mesh(1), cfg)
        pb = (spmm.prepare(br, bc, bv, (k, n), cfg, device="cpu")
              if p is PORT else jax_spmm.prepare(br, bc, bv, (k, n), cfg))
        cr, cc, cv, cshape = p.api.execute_spspmm(sa, pb)
        ref = _dense(ar, ac, av, (m, k)) @ _dense(br, bc, bv, (k, n))
        got = np.zeros(cshape)
        got[cr, cc] = _np(cv).astype(np.float64)
        assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9) < 1e-4
        return [got]

    _both(scenario)


def test_operator_family_worker_in_process():
    """``tests/_operator_family_worker.py`` on CPU meshes: the sharded
    SDDMM at 1, 2 and 4 shards, on the rhs axis and batched, against the
    single-device SDDMM; spspmm of a 4-way by a 2-way sharded input
    against the dense product."""
    rng = np.random.RandomState(0)
    rows, cols, vals = _coo(rng, 1000, 200, 4000)
    shape = (1000, 200)
    cfg = _cfg(PORT)
    plan = spmm.prepare(rows, cols, vals, shape, cfg, device="cpu")
    r = np.random.RandomState(7)
    x = torch.from_numpy(r.randn(3, shape[0], 12).astype(np.float32))
    y = torch.from_numpy(r.randn(3, 12, shape[1]).astype(np.float32))
    for n, axis, xs, ys in ((1, "rows", x[0], y[0]), (2, "rows", x[0], y[0]),
                            (4, "rows", x[0], y[0]), (4, "rhs", x[0], y[0]),
                            (4, "rows", x, y)):
        splan = spmm.prepare_sharded(rows, cols, vals, shape, PORT.mesh(n),
                                     cfg, shard_axis=axis)
        _agree(api.execute_sddmm(splan, xs, ys),
               api.execute_sddmm(plan, xs, ys))
    m, k, n = 400, 200, 160
    ar, ac, av = _coo(rng, m, k, 1500)
    br, bc, bv = _coo(rng, k, n, 1200)
    sa = spmm.prepare_sharded(ar, ac, av, (m, k), PORT.mesh(4), cfg)
    sb = spmm.prepare_sharded(br, bc, bv, (k, n), PORT.mesh(2), cfg)
    cr, cc, cv, cshape = api.execute_spspmm(sa, sb)
    ref = _dense(ar, ac, av, (m, k)) @ _dense(br, bc, bv, (k, n))
    got = np.zeros(cshape)
    got[cr, cc] = cv.numpy().astype(np.float64)
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9) < 1e-4


# ---------------------------------------------------------------------------
# tests/test_cache_correctness.py (sharded cases)
# ---------------------------------------------------------------------------
def test_signatures_unique_across_tier_and_shard_variants():
    def scenario(p, rng):
        m, k = 60, 96
        rows = rng.randint(0, m, 400).astype(np.int64)
        cols = rng.randint(0, k, 400).astype(np.int64)
        vals = rng.randn(400).astype(np.float32)
        cfg = _cfg(p)
        mesh = p.mesh(1)
        plain = (spmm.prepare(rows, cols, vals, (m, k), cfg, device="cpu")
                 if p is PORT else jax_spmm.prepare(rows, cols, vals, (m, k),
                                                    cfg))
        variants = [plain.signature()]
        for axis in ("rows", "rhs"):
            variants.append(p.spmm.prepare_sharded(
                rows, cols, vals, (m, k), mesh, cfg,
                shard_axis=axis).signature())
        tiered = [p.spmm.prepare_sharded(
            rows, cols, vals, (m, k), mesh,
            _cfg(p, bn=128, alpha=1.0, fringe_vmem_budget=budget),
            shard_axis="rows") for budget in (None, 60_000, 4_096)]
        variants += [s.signature() for s in tiered]
        assert len(set(variants)) == len(variants)
        return [np.array([s.stats_dict["fringe_tier"] == t for s, t in zip(
            tiered, ("resident", "ksharded", "xla"))], np.float64)]

    _both(scenario)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 4])
def test_facade_over_a_mesh_runs_every_operator(n):
    """``from_coo(mesh=)`` then ``spmm``, ``bspmm``, ``A @ B``, ``sddmm``,
    ``with_values``, ``spspmm`` and a dynamic sharded matrix, against the
    reference's facade on its 1-device mesh."""
    rng = np.random.RandomState(n)
    a, rows, cols, vals = make_sparse(rng, 300, 120, 0.05, n_dense_rows=4)
    mesh = PORT.mesh(n)
    A = sp.from_coo(rows, cols, vals, a.shape, mesh=mesh)
    JA = jax_sp.from_coo(rows, cols, vals, a.shape, mesh=jax_make_spmm_mesh(1))
    assert A.is_sharded and JA.is_sharded and not A.is_dynamic
    assert A.device == torch.device("cpu")
    b = rng.randn(120, 16).astype(np.float32)
    bb = rng.randn(2, 120, 8).astype(np.float32)
    _agree(sp.spmm(A, b), jax_sp.spmm(JA, b))
    _agree(sp.bspmm(A, torch.from_numpy(bb)), jax_sp.bspmm(JA, bb))
    _agree(A @ torch.from_numpy(b), a.astype(np.float64) @ b)
    x = rng.randn(300, 6).astype(np.float32)
    y = rng.randn(6, 120).astype(np.float32)
    w = sp.sddmm(A, x, y)
    _agree(w, jax_sp.sddmm(JA, x, y))
    A2 = A.with_values(w)
    assert A2.is_sharded
    _agree(sp.spmm(A2, b), jax_sp.spmm(JA.with_values(np.asarray(
        jax_sp.sddmm(JA, x, y))), b))
    P = A @ sp.from_coo(cols, rows, vals, (120, 300), device="cpu")
    assert not P.is_sharded
    _agree(P.dense(), a.astype(np.float64) @ a.T.astype(np.float64))
    D = sp.from_coo(rows, cols, vals, a.shape, mesh=mesh, dynamic=True)
    assert D.is_dynamic and D.is_sharded
    zr, zc = np.nonzero(a == 0)
    D.plan.update(GraphDelta.inserts(zr[:4], zc[:4], np.ones(4)))
    dense = a.astype(np.float64)
    dense[zr[:4], zc[:4]] += 1.0
    _agree(sp.spmm(D, b), dense @ b)
    with pytest.raises(PlanBuildError, match="compact"):
        sp.sddmm(D, x, y)
