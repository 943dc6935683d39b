"""The attention path's spans (``repro_torch.obs.trace``): an ``sddmm``
call span with its ``sddmm_operands``, ``sddmm_walk`` (B5) and
``sddmm_tiles`` (B4) stages, a ``with_values`` span and the layer's
``edge_softmax`` span, beside the SpMMs' ``execute``.

On ``device="cpu"`` plans under telemetry: the names, the counts a
forward of a multi-head layer gives, the span tree, and no device time
(nothing is timed off the card); with the profiler and telemetry off,
nothing.  On the card (``gpu``): device time on the timed calls only, one
call in ``TIME_EVERY``, and stages inside their call.

This file imports only the port.
"""
import numpy as np
import pytest
import torch

import repro_torch.obs as obs
import repro_torch.sparse as sp
from repro_torch.models import GraphTransformerConv
from repro_torch.obs import TRACES, trace
from conftest import make_sparse

SDDMM_STAGES = ["sddmm_operands", "sddmm_walk", "sddmm_tiles"]
HEADS = 3


@pytest.fixture
def clean():
    TRACES.reset()
    yield
    TRACES.set_clock(None)
    TRACES.reset()


def _layer(device, **cfg):
    rng = np.random.RandomState(4)
    a, rows, cols, vals = make_sparse(rng, 256, 256, 0.01, n_dense_rows=4)
    A = sp.from_coo(rows, cols, vals, a.shape, device=device, **cfg)
    assert A.plan.has_core and A.plan.has_fringe
    gen = torch.Generator(device=device).manual_seed(1)
    layer = GraphTransformerConv.init(A, 16, 8, HEADS, generator=gen)
    x = torch.randn((256, 16), generator=gen, device=device)
    return layer, x


def test_attention_spans_under_telemetry(clean):
    layer, x = _layer("cpu", telemetry=True)
    TRACES.reset()
    with torch.no_grad():
        for _ in range(2):
            layer(x)
    tot = obs.snapshot()["span_totals"]
    counts = {n: t["count"] for n, t in tot.items()}
    assert counts["sddmm"] == 2
    assert all(counts[s] == 2 * HEADS for s in SDDMM_STAGES)
    assert counts["edge_softmax"] == 2
    assert counts["with_values"] == 2 * HEADS
    assert counts["execute"] == 2 * HEADS
    # no card: every span recorded, none timed
    assert all(t["device_ns"] == 0 and t["timed"] == 0 for t in tot.values())
    # the SDDMM's stages sit under its call, inside the facade's dispatch
    (tr,) = [t for t in TRACES.snapshot() if t["name"] == "facade:sddmm"][-1:]
    (dispatch,) = tr["spans"]
    (call,) = dispatch["children"]
    assert call["name"] == "sddmm"
    assert [c["name"] for c in call["children"]] == SDDMM_STAGES * HEADS


def test_attention_spans_off_with_profiler_and_telemetry_off(clean):
    layer, x = _layer("cpu")
    TRACES.reset()
    with torch.no_grad():
        layer(x)
    assert TRACES.totals() == {}
    assert TRACES.call("with_values", False, torch.device("cpu")) \
        is trace.NOOP


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_attention_spans_time_the_card(cuda, clean):
    from torch.profiler import ProfilerActivity, profile

    layer, x = _layer(cuda, alpha=0.006)
    with torch.no_grad():
        layer(x)
    torch.cuda.synchronize()
    TRACES.reset()
    TRACES._local.phase = 0.0
    forwards = 32
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.no_grad():
            for _ in range(forwards):
                layer(x)
        torch.cuda.synchronize()
    tot = TRACES.totals()
    calls = {"sddmm": forwards, "edge_softmax": forwards,
             "with_values": forwards * HEADS, "execute": forwards * HEADS}
    opened = sum(calls.values())
    timed = sum(tot[n]["timed"] for n in calls)
    assert timed == pytest.approx(opened / trace.TIME_EVERY, abs=2)
    for name, count in calls.items():
        t = tot[name]
        assert t["count"] == count
        assert 0 < t["timed"] < count, name
        assert t["device_ns"] > 0, name
    for stage in SDDMM_STAGES:
        assert tot[stage]["count"] == forwards * HEADS
        assert tot[stage]["timed"] == tot["sddmm"]["timed"] * HEADS
    stage_ns = sum(tot[s]["device_ns"] for s in SDDMM_STAGES)
    assert stage_ns <= tot["sddmm"]["device_ns"]
