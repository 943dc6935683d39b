"""The port's ``SpmmService`` (``repro_torch.serve``) against the JAX
package's (``repro.serve``), on the CPU.

Every test runs one scenario twice, on the reference's service with
``impl="xla"`` and on the port's with ``impl="torch"``, from the same seed
(the same matrices, panels, mutation streams and fault schedules), and
each run is held to a dense fp64 mirror within 1e-4 as in the reference's
tests.  The two runs must then agree: results within 1e-5 * max(1,
max|ref|), ``ServiceStats`` counters equal, and the same typed errors
(each package's own class of one name).

Mirrored: the 19 tests of ``tests/test_spmm_service.py`` (the sharded
ones on a 1-shard mesh, the port's over the CPU; ``test_sharded_plan_backend``
on both shard axes), the 14 of
``tests/test_service_robustness.py``,
``tests/test_tuner.py::test_service_background_tune_and_warm_health``,
and the five service tests of ``tests/test_telemetry_integration.py``
(span structure, failure outcomes, traced against untraced output,
concurrent services, and the ``health()`` schema, whose key sets must be
the two packages' same).  Then the port alone serves, updates and
warm-starts a rows-sharded plan on a 4-way CPU mesh.

Every wait on a worker thread has a time limit of its own (an event or a
future waited with a timeout, ``drain_compactions(timeout=)``,
``drain_tunings(timeout=)``); time-dependent tests run on an injected
clock (``svc._clock``), never on sleeps.
"""
import dataclasses
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.errors as jax_errors  # noqa: E402
import repro.serve.spmm_service as jax_svc_mod  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.core import tuner as jax_tuner  # noqa: E402
from repro.data import graphs as jax_graphs  # noqa: E402
from repro.dynamic import GraphDelta as JaxGraphDelta  # noqa: E402
from repro.dynamic import PlanRegistry as JaxPlanRegistry  # noqa: E402
from repro.exec import fused_trace_count as jax_fused_trace_count  # noqa
from repro.exec.health import HEALTH as JAX_HEALTH  # noqa: E402
from repro.launch.mesh import make_spmm_mesh as jax_make_spmm_mesh  # noqa
from repro.obs import TRACES as JAX_TRACES  # noqa: E402
from repro.robust import faults as jax_faults  # noqa: E402
from repro.serve import ADMISSION_POLICIES as JAX_POLICIES  # noqa: E402
from repro.serve import SpmmService as JaxSpmmService  # noqa: E402

import repro_torch.errors as errors  # noqa: E402
import repro_torch.serve.spmm_service as svc_mod  # noqa: E402
from repro_torch.core import spmm, tuner  # noqa: E402
from repro_torch.core.plan_ir import general_format_sig  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.distributed import make_spmm_mesh  # noqa: E402
from repro_torch.dynamic import GraphDelta, PlanRegistry  # noqa: E402
from repro_torch.exec import fused_trace_count  # noqa: E402
from repro_torch.exec.health import HEALTH  # noqa: E402
from repro_torch.obs import TRACES  # noqa: E402
from repro_torch.robust import faults  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ADMISSION_POLICIES, ServiceStats, SpmmService,
)
from conftest import make_sparse  # noqa: E402

TOL = 1e-5
WAIT = 30.0   # seconds any single wait on a worker thread may take

PORT = types.SimpleNamespace(
    name="port", Service=SpmmService, impl="torch", spmm=spmm,
    SpmmConfig=spmm.SpmmConfig, GraphDelta=GraphDelta,
    PlanRegistry=PlanRegistry, errors=errors, svc_mod=svc_mod,
    HEALTH=HEALTH, faults=faults, TRACES=TRACES, tuner=tuner,
    graphs=graphs, prepare_call_count=spmm.prepare_call_count,
    fused_trace_count=fused_trace_count, policies=ADMISSION_POLICIES,
)
REF = types.SimpleNamespace(
    name="ref", Service=JaxSpmmService, impl="xla", spmm=jax_spmm,
    SpmmConfig=jax_spmm.SpmmConfig, GraphDelta=JaxGraphDelta,
    PlanRegistry=JaxPlanRegistry, errors=jax_errors, svc_mod=jax_svc_mod,
    HEALTH=JAX_HEALTH, faults=jax_faults, TRACES=JAX_TRACES,
    tuner=jax_tuner, graphs=jax_graphs,
    prepare_call_count=jax_spmm.prepare_call_count,
    fused_trace_count=jax_fused_trace_count, policies=JAX_POLICIES,
)


@pytest.fixture(autouse=True)
def _clean_state():
    for p in (PORT, REF):
        p.faults.HARNESS.reset()
        p.HEALTH.reset()
        p.tuner.reset_for_tests()
        p.TRACES.reset()
    yield
    for p in (PORT, REF):
        p.faults.HARNESS.reset()
        p.HEALTH.reset()
        p.tuner.reset_for_tests()
        p.TRACES.reset()


def _cfg(p, **kw):
    return p.SpmmConfig(impl=p.impl, **kw)


def _np(x):
    return np.asarray(x)


def _close(got, want):
    got, want = _np(got), _np(want)
    tol = TOL * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _mirror(got, dense, p):
    np.testing.assert_allclose(_np(got), dense @ p, rtol=1e-4, atol=1e-4)


def _both(scenario, *args, **kwargs):
    """Run ``scenario(p, rng, ...)`` on the port and on the reference from
    the same seed; return the two observation dicts after comparing
    them: arrays (key ``out*``) within TOL, everything else equal."""
    obs = []
    for p in (PORT, REF):
        rng = np.random.RandomState(0)
        obs.append(scenario(p, rng, *args, **kwargs) or {})
    ours, theirs = obs
    assert ours.keys() == theirs.keys()
    for key in ours:
        if key.startswith("out"):
            assert len(ours[key]) == len(theirs[key]), key
            for a, b in zip(ours[key], theirs[key]):
                _close(a, b)
        else:
            assert ours[key] == theirs[key], (key, ours[key], theirs[key])
    return ours, theirs


def _register(svc, rng, name="g", m=90, k=70):
    a, rows, cols, vals = make_sparse(rng, m, k, 0.08, n_dense_rows=3)
    svc.register(name, rows, cols, vals, a.shape)
    return a


def _stats(svc, timed_folds=False):
    """The service's counters; with ``timed_folds`` without the fold
    counters, which depend on when the worker finishes a fold that nobody
    waits for."""
    out = svc.stats.as_dict()
    if timed_folds:
        out = {k: v for k, v in out.items()
               if not k.startswith("compactions_")}
    return out


# ---------------------------------------------------------------------------
# tests/test_spmm_service.py
# ---------------------------------------------------------------------------
def test_flush_returns_correct_results():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        panels = [rng.randn(70, 16).astype(np.float32) for _ in range(6)]
        tickets = [svc.submit("g", x) for x in panels]
        assert svc.pending("g") == 6
        assert svc.flush() == 6
        assert svc.pending() == 0
        outs = []
        for t, x in zip(tickets, panels):
            outs.append(_np(svc.fetch(t)))
            _mirror(outs[-1], a, x)
        with pytest.raises(KeyError):  # fetch pops
            svc.fetch(tickets[0])
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_bucket_padding_amortizes_traces():
    """Ragged batch sizes pad to power-of-two buckets: flushes of 1 to
    max_batch requests share log2(max_batch)+1 executors."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        _register(svc, rng)
        b = rng.randn(70, 8).astype(np.float32)
        for _ in range(3):
            svc.submit("g", b)
        svc.flush()  # 3 requests -> one bucket-4 dispatch, 1 padded slot
        assert svc.stats.dispatches == 1
        assert svc.stats.padded_slots == 1
        before = p.fused_trace_count()
        for _ in range(3):  # any count <= 4 reuses the bucket-4 executor
            svc.submit("g", b)
        svc.flush()
        assert p.fused_trace_count() == before
        return {"stats": _stats(svc)}

    _both(scenario)


def test_oversized_queue_splits_into_groups():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=2)
        a = _register(svc, rng)
        panels = [rng.randn(70, 8).astype(np.float32) for _ in range(5)]
        tickets = [svc.submit("g", x) for x in panels]
        svc.flush()
        assert svc.stats.dispatches == 3  # 2 + 2 + 1 (padded to 2)
        outs = [_np(svc.fetch(t)) for t in tickets]
        for out, x in zip(outs, panels):
            _mirror(out, a, x)
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_mixed_width_requests_flush_correctly():
    """Panels of different N for one matrix batch per shape group."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        p8 = rng.randn(70, 8).astype(np.float32)
        p16 = rng.randn(70, 16).astype(np.float32)
        t8, t16 = svc.submit("g", p8), svc.submit("g", p16)
        assert svc.flush() == 2
        outs = [_np(svc.fetch(t8)), _np(svc.fetch(t16))]
        _mirror(outs[0], a, p8)
        _mirror(outs[1], a, p16)
        assert svc.stats.dispatches == 2  # one per shape group
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_submit_validates_operand():
    def scenario(p, rng):
        svc = p.Service(_cfg(p))
        _register(svc, rng)
        with pytest.raises(KeyError):
            svc.submit("unknown", np.zeros((70, 4), np.float32))
        with pytest.raises(ValueError, match="must be") as e:
            svc.submit("g", np.zeros((71, 4), np.float32))
        return {"error": type(e.value).__name__, "stats": _stats(svc)}

    _both(scenario)


def test_failed_dispatch_keeps_queue_intact():
    """Requests leave the queue only after a successful dispatch: a failed
    one (here an injected error; on the card a refused or failing
    signature) strands no ticket."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        x = rng.randn(70, 8).astype(np.float32)
        t = svc.submit("g", x)
        boom = RuntimeError("injected dispatch failure")
        orig = svc._execute
        svc._execute = lambda *args: (_ for _ in ()).throw(boom)
        with pytest.raises(RuntimeError, match="injected"):
            svc.flush()
        assert svc.pending("g") == 1  # still queued, not stranded
        svc._execute = orig
        svc.flush()
        out = _np(svc.fetch(t))
        _mirror(out, a, x)
        return {"out": [out], "stats": _stats(svc)}

    _both(scenario)


def test_reregister_with_pending_requests_rejected():
    def scenario(p, rng):
        svc = p.Service(_cfg(p))
        _register(svc, rng)
        svc.submit("g", rng.randn(70, 8).astype(np.float32))
        with pytest.raises(p.errors.AdmissionError, match="pending"):
            _register(svc, rng, m=50, k=40)
        return {"stats": _stats(svc)}

    _both(scenario)


def test_non_pow2_max_batch_rounds_up():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=6)
        assert svc.max_batch == 8
        a = _register(svc, rng)
        b = rng.randn(70, 8).astype(np.float32)
        ts = [svc.submit("g", b) for _ in range(6)]
        svc.flush()  # 6 requests pad to one bucket-8 dispatch
        assert svc.stats.dispatches == 1
        assert svc.stats.padded_slots == 2
        outs = [_np(svc.fetch(t)) for t in ts]
        for out in outs:
            _mirror(out, a, b)
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def _mesh(p, n=1):
    """A mesh of ``n`` shards: the reference's over its CPU device, the
    port's over the CPU repeated."""
    if p is REF:
        return jax_make_spmm_mesh(n)
    return make_spmm_mesh(devices=["cpu"] * n)


def test_submit_rejects_indivisible_n_for_rhs_plan():
    """rhs-sharded divisibility is enforced at submit, while the request is
    still the caller's problem (a flush-time raise would strand batches)."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        real = p.spmm.prepare_sharded(
            np.array([0], np.int64), np.array([0], np.int64),
            np.array([1.0], np.float32), (8, 8), _mesh(p), _cfg(p),
            shard_axis="rhs")
        svc.register_sharded("g", dataclasses.replace(real, n_shards=4))
        with pytest.raises(ValueError, match="divisible"):
            svc.submit("g", np.zeros((8, 30), np.float32))
        svc.submit("g", np.zeros((8, 32), np.float32))  # divisible
        return {"stats": _stats(svc)}

    _both(scenario)


@pytest.mark.parametrize("shard_axis", ["rows", "rhs"])
def test_sharded_plan_backend(shard_axis):
    """The same service front drains through a multi-device plan (the
    reference's test on the rows axis; the rhs axis beside it)."""
    def scenario(p, rng):
        a, rows, cols, vals = make_sparse(rng, 90, 70, 0.08, n_dense_rows=3)
        cfg = _cfg(p)
        splan = p.spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(p),
                                       cfg, shard_axis=shard_axis)
        svc = p.Service(cfg, max_batch=2)
        svc.register_sharded("g", splan)
        panel = rng.randn(70, 12).astype(np.float32)
        t = svc.submit("g", panel)
        svc.flush()
        out = svc.fetch(t)
        _mirror(out, a.astype(np.float64), panel)
        return {"out": [out], "stats": _stats(svc)}

    _both(scenario)


def test_sharded_service_over_a_four_way_mesh(tmp_path):
    """The port alone, at 4 shards of the repeated CPU (the reference's
    tests run a 1-device mesh in process): a rows-sharded dynamic plan
    serves, takes a structural update, persists and warm-starts onto a
    new mesh bit-equal, and ``health()`` reports it serving."""
    rng = np.random.RandomState(5)
    a, rows, cols, vals = make_sparse(rng, 400, 90, 0.05, n_dense_rows=4)
    reg = PlanRegistry(str(tmp_path))
    svc = SpmmService(_cfg(PORT), max_batch=4, registry=reg)
    splan = spmm.prepare_sharded(rows, cols, vals, a.shape, _mesh(PORT, 4),
                                 _cfg(PORT), shard_axis="rows")
    svc.register_sharded("g", splan)
    assert svc.plan("g").is_sharded
    dense = a.astype(np.float64)
    panels = [rng.randn(90, 8).astype(np.float32) for _ in range(3)]
    tickets = [svc.submit("g", x) for x in panels]
    assert svc.flush() == 3
    for t, x in zip(tickets, panels):
        _mirror(svc.fetch(t), dense, x)
    zr, zc = np.nonzero(dense == 0)
    svc.update_matrix("g", GraphDelta.inserts(zr[:5], zc[:5], np.ones(5)))
    dense[zr[:5], zc[:5]] += 1.0
    t = svc.submit("g", panels[0])
    svc.flush()
    before = svc.fetch(t)
    _mirror(before, dense, panels[0])
    reg.save("g", svc.plan("g"))
    svc.warm_start("g", mesh=_mesh(PORT, 4))
    assert svc.plan("g").is_sharded and svc.plan("g").delta_nnz == 5
    t = svc.submit("g", panels[0])
    svc.flush()
    assert torch.equal(svc.fetch(t), before)
    assert svc.health()["matrices"]["g"]["state"] == "serving"
    svc.close()


def test_per_matrix_flush_leaves_other_queues():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        _register(svc, rng, name="g1")
        _register(svc, rng, name="g2", m=50, k=40)
        t1 = svc.submit("g1", rng.randn(70, 8).astype(np.float32))
        t2 = svc.submit("g2", rng.randn(40, 8).astype(np.float32))
        assert svc.flush(name="g1") == 1
        assert svc.pending("g1") == 0
        assert svc.pending("g2") == 1  # untouched
        outs = [_np(svc.fetch(t1))]
        with pytest.raises(KeyError, match="still queued"):
            svc.fetch(t2)
        with pytest.raises(KeyError, match="no matrix registered"):
            svc.flush(name="unknown")
        svc.flush(name="g2")
        outs.append(_np(svc.fetch(t2)))
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_fetch_raises_clear_keyerrors():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        _register(svc, rng)
        t = svc.submit("g", rng.randn(70, 8).astype(np.float32))
        with pytest.raises(KeyError, match="still queued"):
            svc.fetch(t)
        svc.flush()
        svc.fetch(t)
        with pytest.raises(KeyError, match="already fetched"):
            svc.fetch(t)
        with pytest.raises(KeyError, match="never issued"):
            svc.fetch(999)
        return {"stats": _stats(svc)}

    _both(scenario)


def test_update_matrix_serves_mutated_results():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        dense = a.astype(np.float64).copy()
        x = rng.randn(70, 8).astype(np.float32)
        t_pre = svc.submit("g", x)
        rows, cols = np.nonzero(a)
        zr, zc = np.nonzero(a == 0)
        pick = rng.choice(zr.size, 6, replace=False)
        iv = rng.randn(6)
        delta = p.GraphDelta(
            ins_rows=zr[pick], ins_cols=zc[pick], ins_vals=iv,
            del_rows=rows[:4], del_cols=cols[:4])
        stats = svc.update_matrix("g", delta)
        assert stats["delta_nnz"] >= 0
        outs = [_np(svc.fetch(t_pre))]  # drained against the old matrix
        _mirror(outs[0], dense, x)
        dense[zr[pick], zc[pick]] += iv
        dense[rows[:4], cols[:4]] = 0
        t_post = svc.submit("g", x)
        svc.flush()
        outs.append(_np(svc.fetch(t_post)))
        _mirror(outs[1], dense, x)
        assert svc.stats.updates == 1
        with pytest.raises(KeyError):
            svc.update_matrix("nope", delta)
        return {"out": outs, "stats": _stats(svc), "update": stats}

    _both(scenario)


def test_reorder_cols_config_still_serves():
    def scenario(p, rng):
        svc = p.Service(_cfg(p, reorder_cols=True), max_batch=2)
        a = _register(svc, rng)
        x = rng.randn(70, 8).astype(np.float32)
        t = svc.submit("g", x)
        svc.flush()
        out = _np(svc.fetch(t))
        _mirror(out, a, x)
        with pytest.raises(ValueError, match="update"):
            svc.update_matrix("g", p.GraphDelta.deletes([0], [0]))
        return {"out": [out], "stats": _stats(svc)}

    _both(scenario)


def test_update_matrix_over_mutation_stream():
    """The dynamic-serving workload end to end: each package's own
    ``data.graphs.mutate`` stream (the same deltas), against a dense
    mirror at every step."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        dense = a.astype(np.float64).copy()
        rows, cols = np.nonzero(a)
        vals = a[rows, cols]
        x = rng.randn(70, 8).astype(np.float32)
        outs = []
        for delta in p.graphs.mutate(rows, cols, vals, a.shape, steps=4,
                                     insert_frac=0.04, delete_frac=0.03,
                                     update_frac=0.08, seed=5):
            svc.update_matrix("g", delta)
            for r, c, v in zip(delta.ins_rows, delta.ins_cols,
                               delta.ins_vals):
                dense[r, c] += v
            for r, c in zip(delta.del_rows, delta.del_cols):
                dense[r, c] = 0.0
            for r, c, v in zip(delta.upd_rows, delta.upd_cols,
                               delta.upd_vals):
                dense[r, c] = v
            t = svc.submit("g", x)
            svc.flush(name="g")
            outs.append(_np(svc.fetch(t)))
            _mirror(outs[-1], dense, x)
        svc.close()
        # how many updates take the fast path depends on whether a fold
        # had landed: it moves sidecar entries into the base plan
        return {"out": outs, "stats": _stats(svc, timed_folds=True)}

    _both(scenario)


# --- background (async) compaction ------------------------------------------
def _structural_overload(rng, a, p, frac=0.4):
    """Zero-position inserts big enough to force a fold."""
    dense = a.astype(np.float64)
    zr, zc = np.nonzero(dense == 0)
    n = max(1, int(np.count_nonzero(dense) * frac))
    pick = rng.choice(zr.size, n, replace=False)
    iv = rng.randn(n)
    return (p.GraphDelta.inserts(zr[pick], zc[pick], iv),
            (zr[pick], zc[pick], iv))


def _gate(p, monkeypatch):
    """Patch ``_compact_build`` with one that waits for ``release``."""
    real_build = p.svc_mod._compact_build
    started, release = threading.Event(), threading.Event()

    def gated_build(name, dplan, rows, cols, vals):
        started.set()
        assert release.wait(WAIT), "the test never released the fold"
        return real_build(name, dplan, rows, cols, vals)

    monkeypatch.setattr(p.svc_mod, "_compact_build", gated_build)
    return started, release


def test_async_compaction_never_blocks_serving(monkeypatch):
    """A fold runs on the worker; submit/flush/fetch keep serving against
    the old plan and its sidecar until the swap."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        assert svc.async_compaction
        a = _register(svc, rng)
        dense = a.astype(np.float64).copy()
        started, release = _gate(p, monkeypatch)
        delta, (ir, ic, iv) = _structural_overload(rng, a, p)
        stats = svc.update_matrix("g", delta)
        dense[ir, ic] += iv
        assert stats["compacted"] == 0  # nothing folded inline
        assert svc.stats.compactions_scheduled == 1
        assert started.wait(WAIT), "the fold never started on the worker"
        dp = svc.plan("g")
        x = rng.randn(70, 8).astype(np.float32)
        outs = []
        for _ in range(3):  # serving goes on while the fold is held
            t = svc.submit("g", x)
            svc.flush(name="g")
            outs.append(_np(svc.fetch(t)))
            _mirror(outs[-1], dense, x)
        assert dp.compactions == 0 and dp.delta_nnz > 0  # still pre-swap
        release.set()
        svc.drain_compactions(timeout=60)
        assert dp.compactions == 1 and dp.delta_nnz == 0
        assert svc.stats.compactions_applied == 1
        t = svc.submit("g", x)
        svc.flush(name="g")
        outs.append(_np(svc.fetch(t)))
        _mirror(outs[-1], dense, x)
        svc.close()
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_async_compaction_stale_snapshot_reschedules(monkeypatch):
    """A mutation that lands during a fold makes its snapshot stale: the
    fold is discarded and a fresh one runs from the current matrix."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        dense = a.astype(np.float64).copy()
        started, release = _gate(p, monkeypatch)
        delta, (ir, ic, iv) = _structural_overload(rng, a, p)
        svc.update_matrix("g", delta)
        dense[ir, ic] += iv
        assert started.wait(WAIT)
        r0, c0 = int(ir[0]), int(ic[0])
        svc.update_matrix("g", p.GraphDelta.updates([r0], [c0], [9.5]))
        dense[r0, c0] = 9.5
        release.set()
        svc.drain_compactions(timeout=60)
        assert svc.stats.compactions_stale >= 1
        assert svc.stats.compactions_applied >= 1
        assert svc.plan("g").delta_nnz == 0
        x = rng.randn(70, 8).astype(np.float32)
        t = svc.submit("g", x)
        svc.flush(name="g")
        out = _np(svc.fetch(t))
        _mirror(out, dense, x)
        svc.close()
        return {"out": [out], "stats": _stats(svc)}

    _both(scenario)


def test_sync_compaction_opt_out_folds_inline():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4, async_compaction=False)
        a = _register(svc, rng)
        delta, _ = _structural_overload(rng, a, p)
        stats = svc.update_matrix("g", delta)
        assert stats["compacted"] == 1
        assert svc.plan("g").compactions == 1
        assert svc.stats.compactions_scheduled == 0
        return {"stats": _stats(svc), "update": stats}

    _both(scenario)


def _dense_of(svc, name):
    dp = svc.plan(name)
    maps = dp.maps
    dense = np.zeros(dp.shape, np.float64)
    np.add.at(dense, (maps.rows, maps.cols), maps.vals)
    return dense


def test_failed_fold_does_not_discard_other_folds(monkeypatch):
    """A failed background build surfaces its error but never swallows
    another matrix's finished fold from the same poll."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a_good = _register(svc, rng, name="good")
        _register(svc, rng, name="bad", m=88)
        dense = a_good.astype(np.float64).copy()
        real_build = p.svc_mod._compact_build

        def flaky_build(name, dplan, rows, cols, vals):
            if name == "bad":
                raise RuntimeError("injected build failure")
            return real_build(name, dplan, rows, cols, vals)

        monkeypatch.setattr(p.svc_mod, "_compact_build", flaky_build)
        dg, (ir, ic, iv) = _structural_overload(rng, a_good, p)
        svc.update_matrix("good", dg)
        dense[ir, ic] += iv
        db, _ = _structural_overload(rng, _dense_of(svc, "bad"), p)
        svc.update_matrix("bad", db)
        assert svc.stats.compactions_scheduled == 2
        # both folds finish on the worker; then a flush of the good matrix
        # adopts its fold and records the bad one's error without raising
        for _, fut in list(svc._folds.values()):
            fut.exception(timeout=WAIT)
        x = rng.randn(70, 8).astype(np.float32)
        t = svc.submit("good", x)
        svc.flush(name="good")  # must not raise the bad fold's error
        out = _np(svc.fetch(t))
        _mirror(out, dense, x)
        assert svc.plan("good").compactions == 1
        assert svc.plan("good").delta_nnz == 0
        with pytest.raises(RuntimeError, match="injected build failure"):
            svc.drain_compactions(timeout=60)
        assert svc.stats.compactions_failed == 1
        svc.close()
        return {"out": [out], "stats": _stats(svc)}

    _both(scenario)


# ---------------------------------------------------------------------------
# tests/test_service_robustness.py
# ---------------------------------------------------------------------------
def _overload(rng, dense, p, frac=0.4):
    return _structural_overload(rng, dense, p, frac)


def _serve_ok(svc, rng, name, dense, n=8):
    x = rng.randn(dense.shape[1], n).astype(np.float32)
    t = svc.submit(name, x)
    svc.flush(name=name)
    out = _np(svc.fetch(t))
    _mirror(out, dense, x)
    return out


def test_admission_config_validation():
    def scenario(p, rng):
        assert p.policies == ("reject", "shed-oldest")
        for kwargs, match in ((dict(admission_policy="drop-newest"),
                               "admission_policy"),
                              (dict(max_queue=0), "max_queue"),
                              (dict(quarantine_after=0), "quarantine_after"),
                              (dict(max_batch=0), "max_batch")):
            with pytest.raises(p.errors.PlanBuildError, match=match):
                p.Service(_cfg(p), **kwargs)

    _both(scenario)


def test_reject_policy_refuses_overflow_without_stranding():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4, max_queue=2)
        a = _register(svc, rng)
        dense = a.astype(np.float64)
        x = rng.randn(70, 8).astype(np.float32)
        t1, t2 = svc.submit("g", x), svc.submit("g", x)
        with pytest.raises(p.errors.AdmissionError, match="full"):
            svc.submit("g", x)
        assert svc.stats.admission_rejected == 1
        assert svc.pending("g") == 2
        svc.flush()
        outs = [_np(svc.fetch(t)) for t in (t1, t2)]
        for out in outs:
            _mirror(out, dense, x)
        svc.close()
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_shed_oldest_policy_completes_shed_ticket_typed():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4, max_queue=2,
                        admission_policy="shed-oldest")
        a = _register(svc, rng)
        dense = a.astype(np.float64)
        x = rng.randn(70, 8).astype(np.float32)
        t_old = svc.submit("g", x)
        t_mid = svc.submit("g", x)
        t_new = svc.submit("g", x)  # sheds t_old
        assert svc.stats.admission_shed == 1
        assert svc.pending("g") == 2
        svc.flush()
        with pytest.raises(p.errors.AdmissionError, match="shed"):
            svc.fetch(t_old)
        with pytest.raises(KeyError):  # a failure pops once, as a result
            svc.fetch(t_old)
        outs = [_np(svc.fetch(t)) for t in (t_mid, t_new)]
        for out in outs:
            _mirror(out, dense, x)
        svc.close()
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_expired_request_fails_typed_without_stranding_batch():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        dense = a.astype(np.float64)
        now = [0.0]
        svc._clock = lambda: now[0]
        x = rng.randn(70, 8).astype(np.float32)
        t_dead = svc.submit("g", x, timeout=5.0)
        t_live = svc.submit("g", x)  # no deadline
        now[0] = 10.0
        assert svc.flush() == 1  # only the live request dispatches
        assert svc.stats.deadline_expired == 1
        with pytest.raises(p.errors.DeadlineExceeded, match="expired"):
            svc.fetch(t_dead)
        out = _np(svc.fetch(t_live))
        _mirror(out, dense, x)
        svc.close()
        return {"out": [out], "stats": _stats(svc)}

    _both(scenario)


def test_deadline_merges_absolute_and_timeout():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        _register(svc, rng)
        now = [0.0]
        svc._clock = lambda: now[0]
        x = np.zeros((70, 4), np.float32)
        # min(absolute=2.0, now+timeout=100.0) -> expires at t=2
        t = svc.submit("g", x, deadline=2.0, timeout=100.0)
        now[0] = 3.0
        svc.flush()
        with pytest.raises(p.errors.DeadlineExceeded):
            svc.fetch(t)
        t2 = svc.submit("g", x, timeout=100.0)  # a far deadline survives
        svc.flush()
        assert tuple(svc.fetch(t2).shape) == (90, 4)
        svc.close()
        return {"stats": _stats(svc)}

    _both(scenario)


def test_k_fold_failures_quarantine_only_that_matrix():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4, quarantine_after=2)
        a_good = _register(svc, rng, name="good")
        a_bad = _register(svc, rng, name="bad", m=88)
        good = a_good.astype(np.float64).copy()
        bad = a_bad.astype(np.float64).copy()
        outs = []
        with p.faults.armed("fold_build", times=None,
                            match=lambda ctx: ctx == "bad"):
            d1, (ir, ic, iv) = _overload(rng, bad, p)
            svc.update_matrix("bad", d1)
            bad[ir, ic] += iv
            with pytest.raises(p.errors.CompactionError) as e1:
                svc.drain_compactions(timeout=60)
            assert set(e1.value.errors) == {"bad"}
            assert svc.health()["matrices"]["bad"]["state"] == "serving"
            assert svc.stats.quarantines == 0
            d2, (ir, ic, iv) = _overload(rng, bad, p)
            svc.update_matrix("bad", d2)
            bad[ir, ic] += iv
            with pytest.raises(p.errors.CompactionError):
                svc.drain_compactions(timeout=60)
            assert svc.stats.quarantines == 1
            assert svc.health()["matrices"]["bad"]["state"] == "quarantined"
            sched = svc.stats.compactions_scheduled
            d3, (ir, ic, iv) = _overload(rng, bad, p)
            svc.update_matrix("bad", d3)
            bad[ir, ic] += iv
            assert svc.stats.compactions_scheduled == sched
            outs.append(_serve_ok(svc, rng, "bad", bad))
            dg, (ir, ic, iv) = _overload(rng, good, p)
            svc.update_matrix("good", dg)
            good[ir, ic] += iv
            assert svc.drain_compactions(timeout=60) >= 1
            assert svc.plan("good").compactions == 1
            assert svc.health()["matrices"]["good"]["state"] == "serving"
            outs.append(_serve_ok(svc, rng, "good", good))
        a_new = _register(svc, rng, name="bad", m=88)
        h = svc.health()["matrices"]["bad"]
        assert h["state"] == "serving" and h["fold_failures"] == 0
        outs.append(_serve_ok(svc, rng, "bad", a_new.astype(np.float64)))
        svc.close()
        return {"out": outs, "stats": _stats(svc)}

    _both(scenario)


def test_drain_deadline_is_total_not_per_future(monkeypatch):
    """The drain's deadline is one total on the service's clock: here an
    injected clock that moves 0.2 s a read, so the 0.3 s total runs out
    on the second read whatever the host's load."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a = _register(svc, rng)
        _, release = _gate(p, monkeypatch)
        delta, _ = _overload(rng, a.astype(np.float64), p)
        svc.update_matrix("g", delta)
        ticks = [0.0]

        def clock():
            ticks[0] += 0.2
            return ticks[0]

        svc._clock = clock
        t0 = time.monotonic()
        with pytest.raises(p.errors.DeadlineExceeded,
                           match="total deadline"):
            svc.drain_compactions(timeout=0.3)
        assert time.monotonic() - t0 < 10.0  # bounded, not per future
        release.set()
        svc._clock = time.monotonic
        assert svc.drain_compactions(timeout=60) == 1
        svc.close()
        return {"stats": _stats(svc)}

    _both(scenario)


def test_drain_aggregates_every_failed_fold():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=4)
        a1 = _register(svc, rng, name="m1")
        a2 = _register(svc, rng, name="m2", m=88)
        with p.faults.armed("fold_build", times=None):
            for name, a in (("m1", a1), ("m2", a2)):
                delta, _ = _overload(rng, a.astype(np.float64), p)
                svc.update_matrix(name, delta)
            with pytest.raises(p.errors.CompactionError,
                               match=r"2 background fold\(s\) failed") as ei:
                svc.drain_compactions(timeout=60)
        assert set(ei.value.errors) == {"m1", "m2"}
        assert svc.stats.compactions_failed == 2
        svc.close()
        return {"stats": _stats(svc)}

    _both(scenario)


def test_close_is_idempotent_and_gates_every_entry_point():
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=2)
        a = _register(svc, rng)
        svc.close()
        svc.close()  # idempotent
        assert svc.health()["closed"] is True
        x = np.zeros((70, 4), np.float32)
        with pytest.raises(p.errors.AdmissionError, match="closed"):
            svc.submit("g", x)
        with pytest.raises(p.errors.AdmissionError, match="closed"):
            svc.update_matrix("g", p.GraphDelta.updates([0], [0], [1.0]))
        with pytest.raises(p.errors.AdmissionError, match="closed"):
            svc.register("h", *np.nonzero(a), a[np.nonzero(a)], a.shape)
        # a racing fold decision after close never recreates the pool
        dp = svc.plan("g")
        dp.last_decision = types.SimpleNamespace(compact=True)
        svc._maybe_schedule_fold("g", dp)
        assert svc._fold_pool is None
        return {"stats": _stats(svc)}

    _both(scenario)


def test_context_manager_closes_and_surfaces_fold_errors():
    def scenario(p, rng):
        with p.Service(_cfg(p), max_batch=2) as svc:
            a = _register(svc, rng)
            out = _serve_ok(svc, rng, "g", a.astype(np.float64))
        assert svc.health()["closed"] is True
        # a clean exit surfaces close-time fold failures...
        svc2 = p.Service(_cfg(p), max_batch=2)
        a2 = _register(svc2, rng)
        with pytest.raises(p.errors.CompactionError):
            with svc2:
                with p.faults.armed("fold_build", times=None):
                    delta, _ = _overload(rng, a2.astype(np.float64), p)
                    svc2.update_matrix("g", delta)
                    svc2._folds["g"][1].exception(timeout=WAIT)
        assert svc2.health()["closed"] is True
        # ...but never masks an exception already propagating
        svc3 = p.Service(_cfg(p), max_batch=2)
        a3 = _register(svc3, rng)
        with pytest.raises(ValueError, match="user error"):
            with svc3:
                with p.faults.armed("fold_build", times=None):
                    delta, _ = _overload(rng, a3.astype(np.float64), p)
                    svc3.update_matrix("g", delta)
                    svc3._folds["g"][1].exception(timeout=WAIT)
                    raise ValueError("user error")
        assert svc3.health()["closed"] is True
        return {"out": [out], "stats": [_stats(s) for s in (svc, svc2,
                                                            svc3)]}

    _both(scenario)


def test_reregister_discards_in_flight_fold(monkeypatch):
    """A fold built from the plan before a re-register is never adopted by
    the new plan."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=2)
        a = _register(svc, rng)
        started, release = _gate(p, monkeypatch)
        delta, _ = _overload(rng, a.astype(np.float64), p)
        svc.update_matrix("g", delta)
        assert started.wait(WAIT)
        a_new = _register(svc, rng, name="g")  # the queue is empty
        assert "g" not in svc._folds
        release.set()
        assert svc.drain_compactions(timeout=60) == 0
        assert svc.plan("g").compactions == 0
        assert svc.stats.compactions_applied == 0
        out = _serve_ok(svc, rng, "g", a_new.astype(np.float64))
        svc.close()
        return {"out": [out], "stats": _stats(svc)}

    _both(scenario)


def test_crash_mid_save_leaves_registry_warm_startable(tmp_path):
    def scenario(p, rng):
        reg = p.PlanRegistry(str(tmp_path / p.name))
        svc = p.Service(_cfg(p), max_batch=2, registry=reg)
        a = _register(svc, rng)
        dense = a.astype(np.float64)
        r0, c0 = (int(x[0]) for x in np.nonzero(a))
        with p.faults.armed("registry_write"):
            with pytest.raises(p.errors.RegistryError, match="persist"):
                svc.update_matrix("g",
                                  p.GraphDelta.updates([r0], [c0], [5.0]))
        svc.close()
        svc2 = p.Service(_cfg(p), max_batch=2, registry=reg)
        prepares = p.prepare_call_count()
        svc2.warm_start("g")
        assert p.prepare_call_count() == prepares
        assert svc2.stats.warm_starts == 1
        out = _serve_ok(svc2, rng, "g", dense)
        assert svc2.health()["stats"]["registry_generation_fallbacks"] == 0
        svc2.close()
        return {"out": [out], "stats": [_stats(svc), _stats(svc2)]}

    _both(scenario)


def test_health_report_shape(tmp_path):
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=2,
                        registry=p.PlanRegistry(str(tmp_path / p.name)))
        _register(svc, rng)
        svc.submit("g", np.zeros((70, 4), np.float32))
        h = svc.health()
        assert h["closed"] is False
        assert h["matrices"]["g"]["state"] == "serving"
        assert h["matrices"]["g"]["queue_depth"] == 1
        assert h["matrices"]["g"]["fold_in_flight"] is False
        for key in ("requests", "executor_failures", "executor_fallbacks",
                    "faults_fired", "registry_generation_fallbacks"):
            assert key in h["stats"], key
        svc.flush()
        svc.close()
        return {"health": h}

    _both(scenario)


def test_chaos_serving_survives_seeded_faults(tmp_path):
    """The reference's seeded chaos workload: under a fail-once schedule
    over every seam, only typed errors surface and every fetched result
    matches the dense mirror, in both packages; the same seed draws the
    same schedule in both."""
    seed = int(os.environ.get("REPRO_CHAOS_SEED", "0")) % (2 ** 31)

    def scenario(p, rng):
        schedule = p.faults.chaos_schedule(seed, max_offset=4)
        assert schedule
        reg = p.PlanRegistry(str(tmp_path / p.name))
        svc = p.Service(_cfg(p), max_batch=4, registry=reg, max_queue=16)
        a, rows, cols, vals = make_sparse(rng, 64, 48, 0.1, n_dense_rows=2)
        mirror = a.astype(np.float64).copy()
        surfaced, outs = [], []
        for _ in range(5):
            try:
                svc.register("g", rows, cols, vals, a.shape)
                break
            except p.errors.ReproError as e:
                surfaced.append(e)
        else:
            pytest.fail(f"register never recovered: {surfaced}")
        pending = []
        for _ in range(8):
            try:
                svc.flush()
                for t, x in pending:
                    outs.append(_np(svc.fetch(t)))
                    _mirror(outs[-1], mirror, x)
                pending = []
            except p.errors.ReproError as e:
                surfaced.append(e)
            if not pending:
                zr, zc = np.nonzero(mirror == 0)
                pick = rng.choice(zr.size, 3, replace=False)
                iv = rng.randn(3)
                try:
                    svc.update_matrix(
                        "g", p.GraphDelta.inserts(zr[pick], zc[pick], iv))
                    mirror[zr[pick], zc[pick]] += iv
                except p.errors.RegistryError as e:
                    surfaced.append(e)
                    mirror[zr[pick], zc[pick]] += iv
            x = rng.randn(48, 8).astype(np.float32)
            try:
                pending.append((svc.submit("g", x), x))
            except p.errors.ReproError as e:
                surfaced.append(e)
        for _ in range(5):
            try:
                svc.flush()
                break
            except p.errors.ReproError as e:
                surfaced.append(e)
        for t, x in pending:
            outs.append(_np(svc.fetch(t)))
            _mirror(outs[-1], mirror, x)
        try:
            svc.drain_compactions(timeout=60)
        except p.errors.ReproError as e:
            surfaced.append(e)
        try:
            svc.close()
        except p.errors.ReproError as e:
            surfaced.append(e)
        assert all(isinstance(e, p.errors.ReproError) for e in surfaced)
        assert outs
        # which call a seam fails on shifts with when the worker's folds
        # land (a fold's registry save is a registry_write), so the two
        # runs are held to their mirrors and the schedule, not each other
        return {"schedule": schedule}

    _both(scenario)


# ---------------------------------------------------------------------------
# tests/test_tuner.py: the service's background tune
# ---------------------------------------------------------------------------
def test_service_background_tune_and_warm_health(tmp_path):
    def scenario(p, rng):
        p.tuner.set_timer(lambda fn: 1e-3)
        m = k = 64
        mask = rng.rand(m, k) < 0.08
        rows, cols = np.nonzero(mask)
        vals = rng.randn(rows.size)
        reg = p.PlanRegistry(str(tmp_path / p.name))
        cfg = _cfg(p, autotune=True)
        with p.Service(config=cfg, registry=reg) as svc:
            assert svc.config.autotune == "offline"
            svc.register("g", rows, cols, vals, (m, k))
            t = svc.submit("g", rng.randn(k, 8).astype(np.float32))
            svc.flush()
            out = _np(svc.fetch(t))
            if p is PORT:
                svc.drain_tunings(timeout=60)
            else:
                svc.drain_tunings()
            h = svc.health()
            assert h["stats"]["tunings_scheduled"] == 1
            assert h["stats"]["tunings_applied"] == 1
            assert h["stats"]["tuner_records"] == 1
            assert "tuner_store_errors" in h["stats"]
            report = svc.tuning_report()
            assert report["records"]
            (rec,) = report["records"].values()
        p.tuner.reset_for_tests(keep_store=True)
        p.tuner.set_timer(lambda fn: 1e-3)
        with p.Service(config=cfg, registry=reg) as svc2:
            svc2.register("g", rows, cols, vals, (m, k))
            svc2.drain_tunings()
            assert svc2.stats.tunings_scheduled == 0
            assert p.tuner.tune_call_count() == 0
        # the reference also resolves the table at every dispatch (its
        # densify crossover, which no executor of the port reads), so its
        # tuner counts more cold misses and table hits
        stats = {k: v for k, v in h["stats"].items()
                 if k not in ("tuner_cold_misses", "tuner_table_hits")}
        return {"out": [out], "stats": stats,
                "decisions": rec["decisions"], "rates": (rec["p_matrix"],
                                                         rec["p_vector"])}

    _both(scenario)


# ---------------------------------------------------------------------------
# tests/test_telemetry_integration.py: the service
# ---------------------------------------------------------------------------
def _counter_clock(step=0.001):
    state = {"t": 0.0}
    lock = threading.Lock()

    def clock():
        with lock:
            state["t"] += step
            return state["t"]

    return clock


def test_service_span_structure_pinned():
    """An injected deterministic clock pins the traced request's spans."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p, telemetry=True), max_batch=4)
        svc._clock = _counter_clock()
        a, rows, cols, vals = make_sparse(rng, 90, 70, 0.08)
        svc.register("g", rows, cols, vals, a.shape)
        p.TRACES.reset()
        b = rng.randn(70, 8).astype(np.float32)
        ticket = svc.submit("g", b)
        svc.flush()
        out = _np(svc.fetch(ticket))
        _mirror(out, a, b)
        (tr,) = p.TRACES.snapshot()
        assert tr["name"] == "spmm:g"
        assert tr["attrs"]["ticket"] == ticket
        assert tr["attrs"]["outcome"] == "ok"
        spans = [s["name"] for s in tr["spans"]]
        assert spans == ["admit", "queue_wait", "batch_assembly",
                         "dispatch", "block_until_ready", "fetch"]
        for s in tr["spans"]:
            assert s["end_us"] >= s["start_us"]
        assert tr["end_us"] >= tr["start_us"]
        assert tr["spans"][2]["attrs"] == {"batch": 1, "bucket": 1}
        return {"out": [out], "spans": spans,
                "times": [(s["start_us"], s["end_us"])
                          for s in tr["spans"]]}

    _both(scenario)


def test_service_failure_outcomes_traced():
    def scenario(p, rng):
        svc = p.Service(_cfg(p, telemetry=True), max_batch=2, max_queue=1,
                        admission_policy="shed-oldest")
        svc._clock = _counter_clock()
        a, rows, cols, vals = make_sparse(rng, 90, 70, 0.08)
        svc.register("g", rows, cols, vals, a.shape)
        p.TRACES.reset()
        b = rng.randn(70, 8).astype(np.float32)
        t_shed = svc.submit("g", b)
        svc.submit("g", b, timeout=1e-9)  # expires before the drain
        svc.flush()
        outcomes = {t["attrs"]["ticket"]: t["attrs"]["outcome"]
                    for t in p.TRACES.snapshot()}
        assert outcomes[t_shed] == "shed"
        assert "expired" in outcomes.values()
        return {"outcomes": outcomes, "stats": _stats(svc)}

    _both(scenario)


def test_untraced_service_output_matches_traced():
    def scenario(p, rng):
        a, rows, cols, vals = make_sparse(rng, 90, 70, 0.08)
        b = rng.randn(70, 8).astype(np.float32)
        outs = []
        for telemetry in (False, True):
            svc = p.Service(_cfg(p, telemetry=telemetry), max_batch=4)
            svc.register("g", rows, cols, vals, a.shape)
            t = svc.submit("g", b)
            svc.flush()
            outs.append(_np(svc.fetch(t)))
        np.testing.assert_array_equal(outs[0], outs[1])
        return {"out": outs}

    _both(scenario)


def test_registry_survives_concurrent_services():
    """Several services submit, flush and fetch in parallel threads; every
    per-instance stat stays exact in the one registry."""
    def scenario(p, rng):
        a, rows, cols, vals = make_sparse(rng, 64, 48, 0.1)
        n_services, n_requests = 4, 6
        services = []
        for _ in range(n_services):
            svc = p.Service(_cfg(p), max_batch=4)
            svc.register("g", rows, cols, vals, a.shape)
            services.append(svc)
        b = rng.randn(48, 8).astype(np.float32)
        errs, outs = [], [[] for _ in services]

        def drive(i, svc):
            try:
                for _ in range(n_requests):
                    t = svc.submit("g", b)
                    svc.flush()
                    outs[i].append(_np(svc.fetch(t)))
            except BaseException as err:  # surfaced after join
                errs.append(err)

        threads = [threading.Thread(target=drive, args=(i, s))
                   for i, s in enumerate(services)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        for svc in services:
            assert svc.stats.requests == n_requests
            assert svc.stats.flushes == n_requests
            assert svc.stats.dispatches == n_requests
        for row in outs:
            for out in row:
                _mirror(out, a, b)
        return {"out": outs[0], "stats": [_stats(s) for s in services]}

    _both(scenario)


_LEGACY_STATS_KEYS = {
    "requests", "flushes", "dispatches", "padded_slots", "updates",
    "warm_starts", "compactions_scheduled", "compactions_applied",
    "compactions_stale", "compactions_failed", "admission_rejected",
    "admission_shed", "deadline_expired", "quarantines",
    "tunings_scheduled", "tunings_applied", "tunings_failed",
    "executor_signatures", "executor_demoted", "executor_retrying",
    "executor_failures", "executor_fallbacks", "executor_demotions",
    "executor_recoveries",
    "faults_fired",
    "tuner_tune_calls", "tuner_table_hits", "tuner_cold_misses",
    "tuner_measured", "tuner_store_errors", "tuner_records",
}


def test_health_schema_byte_compatible():
    """The port's ``health()`` has the reference's keys, at every level,
    and the same values on the same traffic."""
    def scenario(p, rng):
        svc = p.Service(_cfg(p), max_batch=2)
        a, rows, cols, vals = make_sparse(rng, 90, 70, 0.08)
        svc.register("g", rows, cols, vals, a.shape)
        t = svc.submit("g", rng.randn(70, 8).astype(np.float32))
        svc.flush()
        svc.fetch(t)
        h = svc.health()
        assert set(h) == {"closed", "matrices", "stats"}
        assert set(h["matrices"]["g"]) == {
            "state", "queue_depth", "fold_failures", "fold_in_flight"}
        assert set(h["stats"]) == _LEGACY_STATS_KEYS
        assert h["stats"]["requests"] == 1
        assert h["stats"]["dispatches"] == 1
        assert h["stats"]["flushes"] == 1
        return {"keys": (sorted(h), sorted(h["matrices"]["g"]),
                         sorted(h["stats"])), "health": h}

    _both(scenario)


# ---------------------------------------------------------------------------
# the port only
# ---------------------------------------------------------------------------
def test_counters_and_tuner_table_survive_thread_switching():
    """Stress: more threads than cores, each serving through its own
    service and adopting records into the one process-wide tuner, with
    the interpreter switching threads every microsecond; no counter and
    no record may be lost."""
    import sys

    n_threads = min(4 * (os.cpu_count() or 1), 32)
    n_requests = 4
    a, rows, cols, vals = make_sparse(np.random.RandomState(3), 48, 40,
                                      0.1)
    services = []
    for _ in range(n_threads):
        svc = SpmmService(_cfg(PORT), max_batch=2)
        svc.register("g", rows, cols, vals, a.shape)
        services.append(svc)
    b = np.random.RandomState(4).randn(40, 4).astype(np.float32)
    errs = []

    def drive(i, svc):
        try:
            for j in range(n_requests):
                t = svc.submit("g", b)
                svc.flush()
                _mirror(svc.fetch(t), a, b)
                tuner.get_tuner().adopt(
                    f"stress|{i}|{j}",
                    {"table_format_version": tuner.TABLE_FORMAT_VERSION})
        except BaseException as err:  # surfaced after join
            errs.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive, args=(i, s))
                   for i, s in enumerate(services)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs[:3]
    for svc in services:
        assert svc.stats.requests == svc.stats.dispatches == n_requests
        svc.close()
    counters = tuner.get_tuner().counters()
    assert counters["measured"] == counters["records"] == (
        n_threads * n_requests)


def test_degraded_state_names_the_health_gate(rng):
    """No degrade tier: ``"degraded"`` means that ``exec.health`` retries
    or refuses the matrix's signature (the plan's own, or the general
    payload's that a dispatch with a sidecar runs on), and clears with
    the gate."""
    svc = SpmmService(_cfg(PORT))
    _register(svc, rng)
    sig = svc.plan("g").plan.signature()
    for key in (sig, general_format_sig(sig)):
        HEALTH.record_failure(key, RuntimeError("launch failed"))
        assert svc.health()["matrices"]["g"]["state"] == "degraded"
        HEALTH.reset()
        assert svc.health()["matrices"]["g"]["state"] == "serving"
    svc.close()


def test_service_stats_are_monotone_views():
    stats = ServiceStats()
    stats.requests += 3
    assert stats.requests == 3 and stats.as_dict()["requests"] == 3
    with pytest.raises(ValueError, match="monotone"):
        stats.requests = 1
    with pytest.raises(AttributeError):
        stats.bogus = 1
    assert ServiceStats().requests == 0  # a fresh instance starts at 0


def test_default_service_runs_on_the_card():
    """``SpmmService(SpmmConfig())`` is a ``"cuda"`` service: without a
    card its registration raises, never falling back."""
    svc = SpmmService()
    assert svc.config.impl == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    a, rows, cols, vals = make_sparse(np.random.RandomState(0), 40, 30, 0.1)
    with pytest.raises(Exception, match="(?i)cuda"):
        svc.register("g", rows, cols, vals, a.shape)
    svc.close()


def test_example_serves_a_mutation_stream_and_warm_starts():
    from repro_torch.examples.dynamic_serving import main

    res = main("cpu", "cora", steps=2)
    assert res["restored_prepares"] == 0
    np.testing.assert_array_equal(_np(res["last"]), _np(res["restored"]))
    assert res["builds"] <= 2


@pytest.mark.gpu
def test_refused_dispatch_fails_typed_and_keeps_the_queue():
    """On the card: a signature the health gate refuses makes ``flush``
    raise ``KernelLoweringError`` with the request still queued and
    nothing launched; after the gate clears the request is served."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops

    rng = np.random.RandomState(0)
    svc = SpmmService(spmm.SpmmConfig(), max_batch=4)
    a = _register(svc, rng)
    x = rng.randn(70, 8).astype(np.float32)
    t = svc.submit("g", x)
    sig = svc.plan("g").plan.signature()
    for _ in range(HEALTH.max_retries + 1):
        HEALTH.record_failure(sig, RuntimeError("launch failed"))
    ops.reset_launch_counts()
    with pytest.raises(errors.KernelLoweringError):
        svc.flush()
    assert sum(ops.launch_counts().values()) == 0
    assert svc.pending("g") == 1
    assert svc.health()["matrices"]["g"]["state"] == "degraded"
    HEALTH.reset()
    svc.flush()
    _mirror(svc.fetch(t).cpu(), a, x)
    svc.close()
