"""The readers of the program's own spans (``metrics/*.py`` over
``program_spans.py``) on a stub run: the number each returns from a seeded
``repro_torch.obs`` state, and None where the program recorded nothing or
keeps no such spans."""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.obs as obs
import repro_torch.sparse as sp
from nsbench.harness import Bench

CHECKOUT = Path(__file__).resolve().parents[2]

STAGES = ("validate", "partition", "reorder", "pack", "upload")
CALL_READERS = ("matrix_ms.spmm", "fringe_ms.spmm", "merge_ms.spmm",
                "stall_ms.spmm", "stall_ms.gcn", "spmm_ms.gcn",
                "spmm_host_ms.gcn")
NEW = tuple(f"prepare_s.{s}" for s in STAGES) + (
    "prepare_s.transpose",) + CALL_READERS


@pytest.fixture
def bench():
    return Bench.load(CHECKOUT / "BENCHMARK.json")


@pytest.fixture
def recorder():
    obs.TRACES.reset()
    yield obs.TRACES
    obs.TRACES.set_clock(None)
    obs.TRACES.reset()


def _run(**counters):
    return types.SimpleNamespace(spans={}, counters=counters, trace=None,
                                 setup_s=1.0, cell={}, config={}, mix={})


def _ticks():
    state = {"t": 0.0}

    def clock():
        state["t"] += 1e-3    # one millisecond a read
        return state["t"]

    return clock


def _graph():
    rng = np.random.RandomState(0)
    a = (rng.rand(200, 150) < 0.03) * rng.randn(200, 150)
    a[:4] = rng.randn(4, 150)
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols].astype(np.float32), a.shape


def test_every_new_metric_has_its_reader(bench):
    names = {m["name"] for m in bench.spec["per_layer"]}
    assert set(NEW) <= names
    for name in NEW:
        assert bench.reader(name) is not None


def test_prepare_stage_readers_read_the_newest_prepare(bench, recorder):
    rows, cols, vals, shape = _graph()
    recorder.set_clock(_ticks())
    a = sp.from_coo(rows, cols, vals, shape, device="cpu")
    b = torch.ones((shape[1], 4), requires_grad=True)
    sp.spmm(a, b).sum().backward()     # the transpose plan's build
    run = _run()
    # every stage is one tick (1 ms) of the counter clock; the transpose
    # plan's build is its own open and close, its prepare's open and close
    # and five stages: 13 ticks
    for stage in STAGES:
        assert bench.reader(f"prepare_s.{stage}")(run) == pytest.approx(1e-3)
    assert bench.reader("prepare_s.transpose")(run) == pytest.approx(13e-3)
    # the first plan's prepare is the one prepare root: the transpose
    # plan's, built after it, sits inside its transpose_structure span
    builds = obs.TRACES.build_snapshot()
    (first,) = [t for t in builds if t["spans"][0]["name"] == "prepare"]
    (tr,) = [t for t in builds
             if t["spans"][0]["name"] == "transpose_structure"]
    assert [c["name"] for c in tr["spans"][0]["children"]] == ["prepare"]
    assert first["end_us"] < tr["start_us"]


def _seeded(totals):
    return lambda **kw: {"metrics": {}, "traces": [], "build_traces": [],
                         "span_totals": totals, "roofline": {}}


MS = 1_000_000


def test_call_readers_from_seeded_totals(bench, monkeypatch):
    """80 calls, 10 of them timed on the card."""
    def tot(device_ms, stall_ms=0, host_ms=0):
        return {"count": 80, "host_ns": host_ms * MS,
                "device_ns": device_ms * MS, "stall_ns": stall_ms * MS,
                "timed": 10}

    t = {"execute": tot(100, stall_ms=2, host_ms=30), "matrix": tot(50),
         "fringe": tot(30), "permute_b": tot(5), "matrix_gather": tot(6),
         "fringe_gather": tot(4), "add": tot(3)}
    monkeypatch.setattr(obs, "snapshot", _seeded(t))
    calls = _run(calls=80)
    assert bench.reader("matrix_ms.spmm")(calls) == pytest.approx(5.0)
    assert bench.reader("fringe_ms.spmm")(calls) == pytest.approx(3.0)
    assert bench.reader("merge_ms.spmm")(calls) == pytest.approx(1.8)
    assert bench.reader("stall_ms.spmm")(calls) == pytest.approx(0.2)
    # the four add up to a timed call's device time
    assert sum(bench.reader(n)(calls) for n in CALL_READERS[:4]) \
        == pytest.approx(10.0)
    epochs = _run(epochs=2)     # 40 calls an epoch
    assert bench.reader("stall_ms.gcn")(epochs) == pytest.approx(8.0)
    assert bench.reader("spmm_ms.gcn")(epochs) == pytest.approx(400.0)
    assert bench.reader("spmm_host_ms.gcn")(epochs) == pytest.approx(15.0)


def test_device_readers_read_nothing_without_device_time(bench, recorder):
    """A CPU plan's calls carry host time only: the device readers give
    None, the host one a number."""
    rows, cols, vals, shape = _graph()
    a = sp.from_coo(rows, cols, vals, shape, device="cpu", telemetry=True)
    recorder.set_clock(_ticks())
    for _ in range(3):
        sp.spmm(a, torch.ones((shape[1], 4)))
    run = _run(calls=3, epochs=3)
    for name in CALL_READERS[:-1]:
        assert bench.reader(name)(run) is None, name
    # each execute: its open and close around its stages' two reads each
    (execute,) = obs.TRACES.snapshot()[-1]["spans"][0]["children"]
    ticks = 1 + 2 * len(execute["children"])
    assert bench.reader("spmm_host_ms.gcn")(run) == pytest.approx(ticks)


def test_readers_give_none_when_nothing_was_recorded(bench, recorder):
    run = _run(calls=5, epochs=5)
    for name in NEW:
        assert bench.reader(name)(run) is None, name


def test_readers_give_none_on_a_program_without_spans(bench, monkeypatch):
    """A program whose ``obs.snapshot`` has no span keys (the port before
    its recorder kept them)."""
    monkeypatch.setattr(obs, "snapshot", lambda **kw: {
        "metrics": {}, "traces": [], "roofline": {}})
    run = _run(calls=5, epochs=5)
    for name in NEW:
        assert bench.reader(name)(run) is None, name
