"""The span recorder (``repro_torch.obs.trace``) and its sites in the port.

On ``device="cpu"`` plans: the per-call span tree (names, parents, one
trace id per call, the backward's spans on the thread that runs it), that
nothing is recorded and no range opened with the profiler and telemetry
off, that spans share the profiler's clock, that ``prepare``'s stage
spans cover it and are its ``t_*_s`` stats, that a transpose plan is
built once per structure, and, on a stand-in card, that the timed calls
stand for every call and that a call's stall counts the gaps between its
stages.  On the card (``gpu``): the event pairs' device
times against the profiler's kernels.

This file imports only the port.
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.sparse as sp
from repro_torch.core import spmm
from repro_torch.core.plan_ir import SpmmConfig
from repro_torch.exec import api
from repro_torch.obs import NOOP, TRACES, TraceStore, profiler_active
from repro_torch.obs import trace
from conftest import make_sparse

STAGES = ["permute_b", "matrix", "matrix_gather", "fringe", "fringe_gather",
          "add"]
PREPARE_STAGES = ["validate", "partition", "reorder", "pack", "upload"]


def _counter_clock(step=0.001):
    state = {"t": 0.0, "reads": 0}

    def clock():
        state["t"] += step
        state["reads"] += 1
        return state["t"]

    clock.state = state
    return clock


@pytest.fixture
def clean():
    TRACES.reset()
    yield
    TRACES.set_clock(None)
    TRACES.reset()


def _both_paths(rng, **cfg):
    """A CPU matrix whose plan has tiles and a fringe."""
    a, rows, cols, vals = make_sparse(rng, 256, 192, 0.01, n_dense_rows=4)
    A = sp.from_coo(rows, cols, vals, a.shape, device="cpu", **cfg)
    stats = dict(A.plan.stats)
    assert stats["core_nnz"] and stats["fringe_nnz"]
    return a, A


def _walk(span, parent_id, trace_id):
    """Every span of a subtree has its parent's id and the trace's id."""
    assert span["parent_id"] == parent_id
    assert span["trace_id"] == trace_id
    assert span["start_us"] <= span["end_us"]
    for c in span["children"]:
        assert span["start_us"] <= c["start_us"] <= c["end_us"] \
            <= span["end_us"]
        _walk(c, span["span_id"], trace_id)


def test_call_span_tree_under_the_facade(rng, clean):
    a, A = _both_paths(rng, telemetry=True)
    b = rng.randn(192, 8).astype(np.float32)
    TRACES.reset()
    TRACES.set_clock(_counter_clock())
    out = sp.spmm(A, b)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)
    (tr,) = TRACES.snapshot()
    assert tr["name"] == "facade:spmm" and tr["kind"] == "call"
    assert tr["thread"] == threading.get_ident()
    (dispatch,) = tr["spans"]
    assert dispatch["name"] == "dispatch"
    _walk(dispatch, None, tr["trace_id"])
    (execute,) = dispatch["children"]
    assert execute["name"] == "execute"
    assert execute["attrs"] == {}
    assert [c["name"] for c in execute["children"]] == STAGES
    assert all(not c["children"] for c in execute["children"])
    tot = TRACES.totals()
    assert {n: t["count"] for n, t in tot.items()} == dict(
        {s: 1 for s in STAGES}, dispatch=1, execute=1)
    # the counter clock ticks 1 ms a read: a stage is one tick, and the
    # CPU plan times no device
    assert tot["matrix"]["host_ns"] == 1_000_000
    assert all(t["device_ns"] == 0 and t["stall_ns"] == 0
               for t in tot.values())


def test_backward_spans_on_their_own_thread(rng, clean):
    """The backward's SpMM opens its own root on the thread that runs it
    (autograd's device thread on the card), not under a span open on
    another thread; its stages parent on it."""
    a, A = _both_paths(rng, telemetry=True)
    b = torch.from_numpy(rng.randn(192, 4).astype(np.float32))
    b.requires_grad_(True)
    TRACES.reset()
    out = api.execute(A.plan, b)
    (fwd,) = TRACES.snapshot()
    assert fwd["name"] == "execute"
    assert fwd["spans"][0]["attrs"] == {}
    seen = {}

    def backward():
        seen["thread"] = threading.get_ident()
        out.sum().backward()

    with TRACES.request("outer"):   # open on the main thread only
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    traces = TRACES.snapshot()
    assert [t["name"] for t in traces] == ["execute", "execute", "outer"]
    bwd = traces[1]
    assert bwd["thread"] == seen["thread"] != threading.get_ident()
    assert traces[2]["spans"] == []          # nothing joined "outer"
    (root,) = bwd["spans"]
    assert root["attrs"] == {}
    _walk(root, None, bwd["trace_id"])
    assert [c["name"] for c in root["children"]] == [
        s for s in STAGES if s in {c["name"] for c in root["children"]}]
    assert {c["name"] for c in root["children"]} >= {"permute_b"}
    assert bwd["trace_id"] != fwd["trace_id"]
    np.testing.assert_allclose(b.grad.numpy(), a.T @ np.ones((256, 4)),
                               rtol=1e-4, atol=1e-4)
    # the transpose plan's build is a build trace, with prepare inside
    (build,) = [t for t in TRACES.build_snapshot()
                if t["spans"][0]["name"] == "transpose_structure"]
    assert build["kind"] == "build" and build["thread"] == seen["thread"]
    (prep,) = build["spans"][0]["children"]
    assert prep["name"] == "prepare"
    assert [c["name"] for c in prep["children"]] == PREPARE_STAGES


def test_nothing_recorded_with_profiler_and_telemetry_off(rng, clean,
                                                          monkeypatch):
    a, A = _both_paths(rng)
    b = torch.from_numpy(rng.randn(192, 4).astype(np.float32))
    b.requires_grad_(True)
    api.execute(A.plan, b).sum().backward()   # builds the transpose plan
    assert not profiler_active()
    TRACES.reset()
    clock = _counter_clock()
    TRACES.set_clock(clock)
    ranges = []
    monkeypatch.setattr(trace, "_RANGE", lambda name: ranges.append(name))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: ranges.append(name))

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was created")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    b.grad = None
    sp.spmm(A, b).sum().backward()
    api.execute(A.plan, b.detach())
    assert TRACES.call("execute", False, A.plan.device) is NOOP
    assert TRACES.stage("matrix") is NOOP
    assert clock.state["reads"] == 0
    assert ranges == []
    assert len(TRACES) == 0 and TRACES.build_snapshot() == []
    assert TRACES.totals() == {}


def test_spans_share_the_profilers_clock(rng, clean):
    from torch.profiler import ProfilerActivity, profile

    a, A = _both_paths(rng)     # telemetry off: the profiler turns spans on
    b = torch.from_numpy(rng.randn(192, 8).astype(np.float32))
    TRACES.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiler_active()
        api.execute(A.plan, b)   # the session's first range pays its set-up
        api.execute(A.plan, b)
    _, tr = TRACES.snapshot()
    (root,) = tr["spans"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro_torch."):
            events.setdefault(e.name(), []).append(e)
    assert sorted(events) == sorted(
        "repro_torch." + n for n in ["execute", *STAGES])
    assert all(len(evs) == 2 for evs in events.values())
    # each name's second range is the second call's
    events = {n: [max(evs, key=lambda e: e.start_ns())]
              for n, evs in events.items()}
    (ev,) = events["repro_torch.execute"]
    assert ev.device_type() == torch.autograd.DeviceType.CPU
    assert abs(ev.start_ns() - root["start_us"] * 1e3) < 1e6
    for child in root["children"]:
        (ev,) = events["repro_torch." + child["name"]]
        assert abs(ev.start_ns() - child["start_us"] * 1e3) < 1e6


def test_prepare_stage_spans_cover_it_and_are_its_stats(rng, clean):
    a, rows, cols, vals = make_sparse(rng, 1024, 768, 0.02, n_dense_rows=16)
    # the thread's CPU time, so that the coverage does not depend on how
    # often a busy machine preempts the thread between stages
    TRACES.set_clock(time.thread_time)
    plan = spmm.prepare(rows, cols, vals, a.shape, SpmmConfig(impl="torch"))
    (tr,) = TRACES.build_snapshot()
    (root,) = tr["spans"]
    assert root["name"] == "prepare"
    assert root["attrs"] == {}
    _walk(root, None, tr["trace_id"])
    kids = {c["name"]: c["duration_us"] for c in root["children"]}
    assert list(kids) == PREPARE_STAGES
    assert sum(kids.values()) >= 0.95 * root["duration_us"]
    stats = dict(plan.stats)
    # the stats hold the span's nanoseconds, the trace epoch microseconds
    # as floats (a quarter of a microsecond apart)
    for stage in ("partition", "reorder", "pack"):
        assert stats[f"t_{stage}_s"] == pytest.approx(
            kids[stage] * 1e-6, abs=1e-6)
    # under a deterministic clock each stage is exactly one tick
    TRACES.set_clock(_counter_clock())
    plan = spmm.prepare(rows, cols, vals, a.shape, SpmmConfig(impl="torch"))
    stats = dict(plan.stats)
    assert [stats[f"t_{s}_s"] for s in ("partition", "reorder", "pack")] \
        == pytest.approx([1e-3] * 3)


def test_transpose_structure_once_per_structure(rng, clean):
    a, A = _both_paths(rng)
    b = torch.from_numpy(rng.randn(192, 4).astype(np.float32))
    b.requires_grad_(True)
    TRACES.reset()
    for _ in range(2):
        sp.spmm(A, b).sum().backward()
    # a plan with new values shares the structure's transpose
    A2 = A.with_values(np.asarray(A.val) * 2.0)
    sp.spmm(A2, b).sum().backward()

    def transposes():
        return [t for t in TRACES.build_snapshot()
                if t["spans"][0]["name"] == "transpose_structure"]

    assert len(transposes()) == 1
    _, B = _both_paths(np.random.RandomState(7))
    sp.spmm(B, b).sum().backward()
    assert len(transposes()) == 2


def test_store_rings_and_totals_reset(monkeypatch):
    monkeypatch.setattr(trace, "DEFAULT_BUILD_CAPACITY", 3)
    store = TraceStore(capacity=2, clock=_counter_clock())
    for i in range(5):
        with store.build(f"b{i}"):
            pass
        with store.open(f"c{i}"):
            pass
    assert [t["name"] for t in store.build_snapshot()] == ["b2", "b3", "b4"]
    assert [t["name"] for t in store.snapshot()] == ["c3", "c4"]
    assert store.totals()["b0"] == {"count": 1, "host_ns": 1_000_000,
                                    "device_ns": 0, "stall_ns": 0,
                                    "timed": 0}
    store.reset_totals()
    assert store.totals() == {}
    assert len(store) == 2
    # a build opened inside a per-call span lands in the build ring
    with store.open("call"):
        with store.build("inner"):
            pass
    assert store.build_snapshot()[-1]["name"] == "inner"
    assert store.snapshot()[-1]["spans"][0]["children"] == []
    # an exception closes the span and names itself
    with pytest.raises(KeyError):
        with store.request("req"):
            with store.open("x"):
                raise KeyError
    tr = store.snapshot()[-1]
    assert tr["attrs"]["outcome"] == "KeyError"
    assert tr["spans"][0]["attrs"] == {"error": "KeyError"}


class _FakeCard:
    """Stands in for a CUDA device on the CPU: its events stamp a device
    clock that the test advances (in ms), and every event has completed."""

    def __init__(self):
        self.ms = 0.0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                self.ms = None

            def record(self, stream=None):
                self.ms = card.ms

            def query(self):
                return True

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return end.ms - self.ms

        self.Event = Event


@pytest.mark.parametrize("matrix_ms", [(1.0, 3.0), (1.0, 2.0, 4.0, 8.0)],
                         ids=["2-calls-an-epoch", "4-calls-an-epoch"])
def test_timed_calls_stand_for_every_call(matrix_ms, monkeypatch):
    """A model repeats a fixed sequence of SpMMs an epoch, each with its
    own device time: the timed calls sample every position of it, so the
    mean over timed calls is the mean over all calls; and a call's stall
    is its device time before, between and after its stages."""
    card = _FakeCard()
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "stream")
    store = TraceStore(clock=_counter_clock())
    store._local.phase = 0.0
    cuda = torch.device("cuda")
    epochs = 400
    for _ in range(epochs):
        for ms in matrix_ms:
            with store.call("execute", True, cuda):
                card.ms += 0.25                 # before the first stage
                with store.stage("matrix"):
                    card.ms += ms
                card.ms += 0.5                  # between the stages
                with store.stage("fringe"):
                    card.ms += 1.0
    tot = store.totals()
    calls = epochs * len(matrix_ms)
    ex, mat, fr = tot["execute"], tot["matrix"], tot["fringe"]
    assert ex["count"] == mat["count"] == calls
    assert ex["timed"] == mat["timed"] == fr["timed"]
    assert ex["timed"] == pytest.approx(calls / trace.TIME_EVERY, rel=0.02)
    mean_ms = sum(matrix_ms) / len(matrix_ms)
    assert mat["device_ns"] / mat["timed"] * 1e-6 == pytest.approx(
        mean_ms, rel=0.05)
    assert fr["device_ns"] / fr["timed"] * 1e-6 == pytest.approx(1.0)
    assert ex["stall_ns"] / ex["timed"] * 1e-6 == pytest.approx(0.75)
    assert ex["device_ns"] == pytest.approx(
        mat["device_ns"] + fr["device_ns"] + ex["stall_ns"], abs=2 * calls)
    assert not store._pending


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_event_pairs_time_the_card(cuda, clean):
    """One in TIME_EVERY calls' and their stages' device time from their
    event pairs: the stages and the stall add up to the calls, a timed
    call fits inside the loop's own event pair, and holds at least the
    kernels the profiler saw launched a call."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(3)
    a, rows, cols, vals = make_sparse(rng, 4096, 4096, 0.004,
                                      n_dense_rows=64)
    A = sp.from_coo(rows, cols, vals, a.shape, device=cuda)
    b = torch.randn(4096, 256, device=cuda)
    for _ in range(3):
        sp.spmm(A, b)
    torch.cuda.synchronize()
    TRACES.reset()
    TRACES._local.phase = 0.0   # from phase 0, 4 of 32 calls are timed
    calls = 4 * trace.TIME_EVERY
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            sp.spmm(A, b)
        end.record()
        torch.cuda.synchronize()
    tot = TRACES.totals()
    ex = tot["execute"]
    assert ex["count"] == calls and ex["timed"] == 4
    stages = [s for s in STAGES if s in tot]
    assert {"matrix", "fringe"} <= set(stages)
    assert all(tot[s]["count"] == calls and tot[s]["timed"] == 4
               for s in stages)
    assert tot["matrix"]["device_ns"] > 0 and tot["fringe"]["device_ns"] > 0
    stage_ns = sum(tot[s]["device_ns"] for s in stages)
    assert stage_ns + ex["stall_ns"] == pytest.approx(ex["device_ns"],
                                                      rel=1e-3)
    per_call_ns = ex["device_ns"] / ex["timed"]
    assert per_call_ns <= 1.25 * start.elapsed_time(end) * 1e6 / calls
    kernel_ns = sum(e.duration_ns()
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation())
    assert per_call_ns >= 0.95 * kernel_ns / calls
    assert not TRACES._pending
