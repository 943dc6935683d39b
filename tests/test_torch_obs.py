"""repro_torch.obs against repro.obs, and telemetry on the port's plans.

The first part mirrors ``tests/test_obs.py`` on the port's registry
(types, labels, cardinality caps, thread safety, Prometheus round-trip),
trace store (deterministic clock, ring bound), dispatch profiler ring and
roofline attribution math: pure host code, so the same assertions hold.
The second part is the port of the parts of
``tests/test_telemetry_integration.py`` that need no service and no
health table: ``SpmmConfig.telemetry`` is signature-invisible; results
are bit-identical with it on and off, with no extra executor builds or
dispatches; nothing is recorded with it off; a profiled run gives roofline
rows against the H100's ceilings; SDDMM and the per-path executors are
profiled; the facade records its spans; the counter hooks are views over
the registry.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import repro_torch.obs as obs
import repro_torch.sparse as sp
from repro_torch.core import spmm
from repro_torch.core.cost_model import (
    H100_FP32_FLOPS_PER_S, H100_HBM_BYTES_PER_S,
)
from repro_torch.core.plan_ir import SpmmConfig
from repro_torch.exec import api
from repro_torch.obs import (
    PROFILER,
    TRACES,
    DispatchProfiler,
    DispatchRecord,
    MetricsRegistry,
    TraceStore,
    format_report,
    format_sample,
    instance_label,
    parse_prometheus_text,
    roofline_attribution,
    roofline_prometheus,
)
from repro_torch.obs.metrics import OVERFLOW_LABEL
from conftest import make_sparse


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_basics():
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "requests", labelnames=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="a")
    c.inc(kind="b")
    assert c.value(kind="a") == 3
    assert c.value(kind="b") == 1
    assert c.value(kind="absent") == 0
    assert c.total() == 4
    assert c.series() == {("a",): 3.0, ("b",): 1.0}


def test_counter_monotone():
    reg = MetricsRegistry()
    c = reg.counter("x_total")
    with pytest.raises(ValueError):
        c.inc(-1)


def test_counter_label_validation():
    reg = MetricsRegistry()
    c = reg.counter("y_total", labelnames=("kind",))
    with pytest.raises(ValueError):
        c.inc()  # missing label
    with pytest.raises(ValueError):
        c.inc(kind="a", extra="b")  # unknown label


def test_gauge():
    reg = MetricsRegistry()
    g = reg.gauge("depth")
    g.set(5)
    g.inc(2)
    g.dec()
    assert g.value() == 6
    g.set(-3)
    assert g.value() == -3  # gauges may go negative


def test_histogram_buckets():
    reg = MetricsRegistry()
    h = reg.histogram("lat_us", buckets=(10.0, 100.0))
    for v in (1, 10, 50, 1000):
        h.observe(v)
    snap = h.snapshot()["series"][0]["value"]
    # cumulative: <=10 holds {1, 10}, <=100 adds {50}, +Inf adds {1000}
    assert snap["buckets"] == {"10.0": 2, "100.0": 3, "+Inf": 4}
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(1061.0)


def test_idempotent_registration():
    reg = MetricsRegistry()
    a = reg.counter("same_total", labelnames=("k",))
    b = reg.counter("same_total", labelnames=("k",))
    assert a is b
    with pytest.raises(ValueError):
        reg.counter("same_total", labelnames=("other",))
    with pytest.raises(ValueError):
        reg.gauge("same_total", labelnames=("k",))


def test_cardinality_cap_collapses_to_overflow():
    reg = MetricsRegistry()
    c = reg.counter("capped_total", labelnames=("id",), max_series=3)
    for i in range(10):
        c.inc(id=str(i))
    # 3 real series at the cap; the rest collapsed into __other__
    series = c.series()
    assert len(series) == 4
    assert series[(OVERFLOW_LABEL,)] == 7.0
    assert reg.dropped_series() == {"capped_total": 7}
    assert reg.snapshot()["__dropped_series__"] == {"capped_total": 7}


def test_reset_values_keeps_registration():
    reg = MetricsRegistry()
    c = reg.counter("r_total")
    c.inc(5)
    reg.reset_values()
    assert c.total() == 0
    assert reg.get("r_total") is c  # object survives, only values reset
    c.inc()
    assert c.total() == 1


def test_registry_thread_safety():
    reg = MetricsRegistry()
    c = reg.counter("threaded_total", labelnames=("t",))
    h = reg.histogram("threaded_us", buckets=(10.0,))
    n_threads, n_iter = 8, 500

    def work(tid):
        for _ in range(n_iter):
            c.inc(t=str(tid % 2))
            h.observe(1.0)
            reg.snapshot()  # snapshots interleave with mutation

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.total() == n_threads * n_iter
    snap = h.snapshot()["series"][0]["value"]
    assert snap["count"] == n_threads * n_iter


def test_instance_label_unique():
    a, b = instance_label("svc"), instance_label("svc")
    assert a != b and a.startswith("svc") and b.startswith("svc")


# ---------------------------------------------------------------------------
# Prometheus text round-trip
# ---------------------------------------------------------------------------


def test_format_sample_escaping():
    line = format_sample("m", {"k": 'va"l\\ue\n'}, 1)
    parsed = parse_prometheus_text(line)
    assert parsed == {"m": {(("k", 'va"l\\ue\n'),): 1.0}}


def test_prometheus_round_trip():
    reg = MetricsRegistry()
    c = reg.counter("rt_total", "help with\nnewline", labelnames=("kind",))
    c.inc(3, kind="a")
    c.inc(kind="b")
    g = reg.gauge("rt_depth")
    g.set(2.5)
    h = reg.histogram("rt_us", buckets=(10.0, 100.0))
    h.observe(5)
    h.observe(500)

    parsed = parse_prometheus_text(reg.to_prometheus())
    assert parsed["rt_total"] == {(("kind", "a"),): 3.0, (("kind", "b"),): 1.0}
    assert parsed["rt_depth"] == {(): 2.5}
    assert parsed["rt_us_bucket"] == {
        (("le", "10.0"),): 1.0, (("le", "100.0"),): 1.0, (("le", "+Inf"),): 2.0,
    }
    assert parsed["rt_us_sum"] == {(): 505.0}
    assert parsed["rt_us_count"] == {(): 2.0}


# ---------------------------------------------------------------------------
# trace store
# ---------------------------------------------------------------------------


def _counter_clock(step=0.001):
    state = {"t": 0.0}

    def clock():
        state["t"] += step
        return state["t"]

    return clock


def test_trace_deterministic_clock():
    store = TraceStore(capacity=8, clock=_counter_clock())
    tr = store.begin("req", ticket=7)
    store.add_span(tr, "admit", 100.0, 200.0, deadline=None)
    with store.span(tr, "dispatch"):
        pass
    store.end(tr)
    assert len(store) == 1
    snap = store.snapshot()[0]
    assert snap["name"] == "req"
    assert snap["attrs"]["ticket"] == 7
    assert [s["name"] for s in snap["spans"]] == ["admit", "dispatch"]
    assert snap["spans"][0]["duration_us"] == pytest.approx(100.0)
    # counter clock ticks 1000us per read: dispatch span is exactly one tick
    assert snap["spans"][1]["duration_us"] == pytest.approx(1000.0)


def test_trace_ring_bounded():
    store = TraceStore(capacity=4, clock=_counter_clock())
    for i in range(10):
        store.end(store.begin(f"t{i}"))
    assert len(store) == 4
    assert [t["name"] for t in store.snapshot()] == ["t6", "t7", "t8", "t9"]
    assert [t["name"] for t in store.snapshot(2)] == ["t8", "t9"]


# ---------------------------------------------------------------------------
# profiler + roofline attribution
# ---------------------------------------------------------------------------

PEAKS = {"flops_per_s": 1e9, "bytes_per_s": 1e9}


def _rec(op="spmm", tier="pallas", sig="aaaa", measured_us=30.0,
         traced=False, matrix=(10_000.0, 100.0), fringe=(100.0, 10_000.0)):
    return DispatchRecord(
        op=op, tier=tier, sig_key=sig, kind=op, measured_us=measured_us,
        traced=traced, batch=None,
        terms={"matrix": {"flops": matrix[0], "bytes": matrix[1]},
               "fringe": {"flops": fringe[0], "bytes": fringe[1]}},
        peaks=PEAKS,
    )


def test_profiler_ring():
    prof = DispatchProfiler(capacity=3)
    for i in range(5):
        prof.record(op="spmm", tier="xla", sig_key=f"{i}", kind="spmm",
                    measured_us=1.0, traced=False, batch=None, terms={},
                    peaks=PEAKS)
    recs = prof.records()
    assert len(recs) == 3
    assert [r.sig_key for r in recs] == ["2", "3", "4"]
    prof.reset()
    assert len(prof) == 0


def test_roofline_attribution_math():
    # matrix path: compute-bound at 10us; fringe path: memory-bound at 10us
    attr = roofline_attribution([_rec(measured_us=40.0)])
    (row,) = attr["rows"]
    assert row["calls"] == 1
    assert row["measured_us"] == pytest.approx(40.0)
    mat, fr = row["paths"]["matrix"], row["paths"]["fringe"]
    assert mat["bound_us"] == pytest.approx(10.0)
    assert fr["bound_us"] == pytest.approx(10.0)
    assert mat["bound"] == "compute" and fr["bound"] == "memory"
    # equal bounds -> measured wall attributed 50/50
    assert mat["share"] == pytest.approx(0.5)
    assert mat["attributed_us"] == pytest.approx(20.0)
    assert row["utilization"] == pytest.approx(0.5)  # 20us bound / 40us wall
    assert attr["matrix_path"]["attributed_us"] == pytest.approx(20.0)
    assert attr["fringe_path"]["attributed_us"] == pytest.approx(20.0)
    assert attr["utilization"] == pytest.approx(0.5)


def test_roofline_groups_by_op_tier_sig():
    attr = roofline_attribution([
        _rec(sig="a"), _rec(sig="a"), _rec(sig="b"), _rec(tier="xla"),
    ])
    keys = [(r["op"], r["tier"], r["sig"]) for r in attr["rows"]]
    assert sorted(keys) == keys  # deterministic order
    assert len(keys) == 3
    by_key = {k: r for k, r in zip(keys, attr["rows"])}
    assert by_key[("spmm", "pallas", "a")]["calls"] == 2


def test_roofline_excludes_traced_by_default():
    recs = [_rec(measured_us=1e6, traced=True), _rec(measured_us=30.0)]
    attr = roofline_attribution(recs)
    assert attr["skipped_traced"] == 1
    assert attr["measured_us_total"] == pytest.approx(30.0)
    attr_all = roofline_attribution(recs, include_traced=True)
    assert attr_all["skipped_traced"] == 0
    assert attr_all["measured_us_total"] == pytest.approx(1e6 + 30.0)


def test_roofline_prometheus_round_trip():
    attr = roofline_attribution([_rec(measured_us=40.0)])
    parsed = parse_prometheus_text(roofline_prometheus(attr))
    base = (("op", "spmm"), ("sig", "aaaa"), ("tier", "pallas"))
    assert parsed["repro_roofline_calls"][base] == 1.0
    assert parsed["repro_roofline_measured_us"][base] == pytest.approx(40.0)
    mat = tuple(sorted(base + (("path", "matrix"),)))
    assert parsed["repro_roofline_bound_us"][mat] == pytest.approx(10.0)
    agg = (("op", "_all"), ("path", "fringe"), ("sig", "_all"),
           ("tier", "_all"))
    assert parsed["repro_roofline_attributed_us"][agg] == pytest.approx(20.0)


# ---------------------------------------------------------------------------
# the port's obs against the reference's
# ---------------------------------------------------------------------------


def test_roofline_matches_reference_on_the_same_records():
    jax_obs = pytest.importorskip("repro.obs")
    recs = [dict(op="spmm", tier="t", sig_key=s, kind="spmm",
                 measured_us=m, traced=tr, batch=None,
                 terms={"matrix": {"flops": f, "bytes": 10 * f},
                        "fringe": {"flops": 3 * f, "bytes": f}},
                 peaks=PEAKS, attrs={"padding_waste": w,
                                     "matrix_format": "general"})
            for s, m, tr, f, w in (("a", 40.0, False, 1e4, 0.5),
                                   ("a", 20.0, False, 2e4, 0.25),
                                   ("b", 9.0, True, 5e3, 0.0),
                                   ("c", 7.0, False, 0.0, 0.1))]
    for include_traced in (False, True):
        ours = roofline_attribution([DispatchRecord(**r) for r in recs],
                                    include_traced=include_traced)
        theirs = jax_obs.roofline_attribution(
            [jax_obs.DispatchRecord(**r) for r in recs],
            include_traced=include_traced)
        assert ours == theirs
        assert roofline_prometheus(ours) == jax_obs.roofline_prometheus(
            theirs)
        assert format_report(ours) == jax_obs.format_report(theirs)


# ---------------------------------------------------------------------------
# telemetry on the port's plans
# ---------------------------------------------------------------------------


def _prepare_pair(rng, m=96, k=80, **overrides):
    """The same matrix prepared with telemetry off and on."""
    a, rows, cols, vals = make_sparse(rng, m, k, 0.08, n_dense_rows=3)
    cfg_off = SpmmConfig(impl="torch", **overrides)
    cfg_on = dataclasses.replace(cfg_off, telemetry=True)
    p_off = spmm.prepare(rows, cols, vals, a.shape, cfg_off)
    p_on = spmm.prepare(rows, cols, vals, a.shape, cfg_on)
    return a, p_off, p_on


def test_telemetry_is_signature_invisible(rng):
    _, p_off, p_on = _prepare_pair(rng)
    assert p_off.signature() == p_on.signature()


@pytest.mark.parametrize("op", ["spmm", "bspmm", "matrix_path",
                                "vector_path", "sddmm"])
def test_telemetry_bit_identical_no_extra_builds_or_dispatches(rng, op):
    a, p_off, p_on = _prepare_pair(rng, alpha=0.5)
    assert p_on.has_core and p_on.has_fringe
    b = torch.from_numpy(rng.randn(a.shape[1], 16).astype(np.float32))
    bb = torch.from_numpy(rng.randn(2, a.shape[1], 16).astype(np.float32))
    x = torch.from_numpy(rng.randn(a.shape[0], 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(8, a.shape[1]).astype(np.float32))
    call = {"spmm": lambda p: api.execute(p, b),
            "bspmm": lambda p: api.execute(p, bb),
            "matrix_path": lambda p: api.execute_matrix_path(p, b),
            "vector_path": lambda p: api.execute_vector_path(p, b),
            "sddmm": lambda p: api.execute_sddmm(p, x, y)}[op]
    # warm: the same signature shares one cached executor, so the deltas
    # below count exactly the one dispatch each
    call(p_off)
    outs, deltas = [], []
    for plan in (p_off, p_on):
        builds0, disp0 = api.fused_trace_count(), api.dispatch_count()
        outs.append(call(plan))
        deltas.append((api.fused_trace_count() - builds0,
                       api.dispatch_count() - disp0))
    assert torch.equal(outs[0], outs[1])     # bit-identical
    assert deltas[0] == deltas[1]            # no extra builds or dispatches
    assert deltas[0][0] == 0


def test_telemetry_off_records_nothing(rng):
    a, p_off, _ = _prepare_pair(rng)
    b = torch.from_numpy(rng.randn(a.shape[1], 8).astype(np.float32))
    PROFILER.reset()
    api.execute(p_off, b)
    api.execute_matrix_path(p_off, b)
    api.execute_vector_path(p_off, b)
    assert len(PROFILER) == 0


def test_roofline_snapshot_for_profiled_run(rng):
    # unique shape -> fresh signature -> the first call builds its
    # executor; alpha=0.5 routes the sparse tail onto the fringe path so
    # both engines carry modeled work
    a, _, p_on = _prepare_pair(rng, m=97, k=83, alpha=0.5)
    b = torch.from_numpy(rng.randn(a.shape[1], 16).astype(np.float32))
    PROFILER.reset()
    api.execute(p_on, b)  # first call builds -> excluded from the report
    for _ in range(3):
        api.execute(p_on, b)

    snap = obs.snapshot()
    attr = snap["roofline"]
    assert attr["skipped_traced"] >= 1
    (row,) = attr["rows"]
    assert row["op"] == "spmm" and row["tier"] == "torch"
    assert row["calls"] == 3
    assert row["measured_us"] > 0
    # the H100's ceilings, not the TPU's
    assert row["peaks"] == {"flops_per_s": H100_FP32_FLOPS_PER_S,
                            "bytes_per_s": H100_HBM_BYTES_PER_S}
    assert row["paths"]["matrix"]["flops"] > 0
    assert row["paths"]["fringe"]["flops"] > 0
    shares = [row["paths"][p]["share"] for p in ("matrix", "fringe")]
    assert sum(shares) == pytest.approx(1.0)
    attributed = (attr["matrix_path"]["attributed_us"]
                  + attr["fringe_path"]["attributed_us"])
    assert attributed == pytest.approx(attr["measured_us_total"])
    json.dumps(snap)    # JSON-serializable

    # Prometheus export round-trips the same numbers
    parsed = parse_prometheus_text(obs.prometheus_text())
    key = (("op", "spmm"), ("sig", row["sig"]), ("tier", "torch"))
    assert parsed["repro_roofline_calls"][key] == 3.0
    assert parsed["repro_roofline_measured_us"][key] == pytest.approx(
        row["measured_us"])


def test_per_path_dispatches_profiled_on_their_own_path(rng):
    a, _, p_on = _prepare_pair(rng, m=91, k=77, alpha=0.5)
    b = torch.from_numpy(rng.randn(a.shape[1], 16).astype(np.float32))
    PROFILER.reset()
    for _ in range(2):
        api.execute_matrix_path(p_on, b)
        api.execute_vector_path(p_on, b)
    rows = {r["op"]: r for r in obs.roofline(include_traced=True)["rows"]}
    assert set(rows) == {"spmm:matrix_path", "spmm:vector_path"}
    mat, vec = rows["spmm:matrix_path"], rows["spmm:vector_path"]
    assert mat["calls"] == vec["calls"] == 2
    assert mat["paths"]["matrix"]["share"] == 1.0
    assert mat["paths"]["fringe"]["flops"] == 0.0
    assert vec["paths"]["fringe"]["share"] == 1.0
    assert vec["paths"]["matrix"]["flops"] == 0.0
    # no record for an empty path: it dispatches nothing
    _, _, all_fringe = _prepare_pair(rng, m=91, k=77, alpha=1.0)
    PROFILER.reset()
    api.execute_matrix_path(all_fringe, b)
    assert len(PROFILER) == 0


def test_sddmm_profiled(rng):
    a, rows, cols, vals = make_sparse(rng, 48, 48, 0.1)
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu", telemetry=True)
    x = rng.randn(48, 8).astype(np.float32)
    y = rng.randn(8, 48).astype(np.float32)
    PROFILER.reset()
    sp.sddmm(A, x, y)
    assert {r.op for r in PROFILER.records()} == {"sddmm"}


def test_facade_trace_spans(rng):
    a, rows, cols, vals = make_sparse(rng, 64, 48, 0.1)
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu", telemetry=True)
    b = rng.randn(48, 8).astype(np.float32)
    TRACES.reset()
    out = sp.spmm(A, b)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)
    sp.bspmm(A, torch.from_numpy(np.stack([b, b])))
    sp.sddmm(A, rng.randn(64, 4).astype(np.float32),
             rng.randn(4, 48).astype(np.float32))
    traces = TRACES.snapshot()
    assert [t["name"] for t in traces] == [
        "facade:spmm", "facade:bspmm", "facade:sddmm"]
    for tr in traces:
        assert tr["attrs"]["outcome"] == "ok"
        assert [s["name"] for s in tr["spans"]] == ["dispatch"]


def test_facade_failure_outcome_traced(rng):
    a, rows, cols, vals = make_sparse(rng, 64, 48, 0.1)
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu", telemetry=True)
    TRACES.reset()
    with pytest.raises(ValueError):
        sp.spmm(A, np.zeros((47, 8), np.float32))   # wrong K
    (tr,) = TRACES.snapshot()
    assert tr["attrs"]["outcome"] == "ValueError"


def test_facade_without_telemetry_traces_nothing(rng):
    a, rows, cols, vals = make_sparse(rng, 64, 48, 0.1)
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu")
    TRACES.reset()
    sp.spmm(A, rng.randn(48, 8).astype(np.float32))
    assert len(TRACES) == 0


def test_hook_wrappers_still_count(rng):
    """The port's test hooks are views over the shared registry."""
    a, rows, cols, vals = make_sparse(rng, 64, 48, 0.1)
    p0 = spmm.prepare_call_count()
    cfg = SpmmConfig(impl="torch", bn=32)   # distinct signature: a build
    plan = spmm.prepare(rows, cols, vals, a.shape, cfg)
    assert spmm.prepare_call_count() == p0 + 1
    b = torch.from_numpy(
        np.random.RandomState(1).randn(48, 8).astype(np.float32))
    t0, d0 = api.fused_trace_count(), api.dispatch_count()
    api.execute(plan, b)
    api.execute(plan, b)
    assert api.fused_trace_count() == t0 + 1   # built once, reused once
    assert api.dispatch_count() == d0 + 2
    reg = obs.REGISTRY
    assert reg.get("exec_traces_total").total() == api.fused_trace_count()
    assert reg.get("exec_dispatches_total").total() == api.dispatch_count()
    assert reg.get("core_prepares_total").total() == (
        spmm.prepare_call_count())
