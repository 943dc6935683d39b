"""The trace's reduction on a hand-made trace: busy and idle time, the
top device operations, and idle gaps named by the host's activity."""
import pytest

from nsbench import trace

MS = 1_000_000  # ns


def test_busy_idle_and_gaps():
    ev = [
        ("nsbench.window", "user_annotation", 0, 100 * MS, 1),
        ("nsbench.spmm", "user_annotation", 1 * MS, 9 * MS, 1),
        ("aten::mm", "cpu_op", 2 * MS, 8 * MS, 1),
        ("nsbench.gcn.loss_item", "user_annotation", 60 * MS, 99 * MS, 1),
        ("aten::item", "cpu_op", 61 * MS, 98 * MS, 1),
        # device: two overlapping kernels, a copy, and a GPU-side range
        ("k1", "kernel", 10 * MS, 30 * MS, 7),
        ("k2", "kernel", 20 * MS, 40 * MS, 7),
        ("Memcpy DtoH", "kernel", 50 * MS, 55 * MS, 7),
        ("nsbench.spmm", "gpu_user_annotation", 0, 100 * MS, 7),
        ("k1", "kernel", 95 * MS, 120 * MS, 7),   # cut at the window's end
        ("k0", "kernel", -5 * MS, -1 * MS, 7),    # before the window
    ]
    s = trace.summarize_events(ev)
    assert s.window_s == pytest.approx(0.1)
    # busy: 10-40, 50-55, 95-100
    assert s.busy_s == pytest.approx(0.040)
    assert s.device_sum_s == pytest.approx(0.020 + 0.020 + 0.005 + 0.005)
    assert s.idle_frac == pytest.approx(0.6)
    assert dict(s.device_ops) == pytest.approx(
        {"k1": 0.025, "k2": 0.020, "Memcpy DtoH": 0.005})
    gaps = dict(s.idle_gaps)
    # 0-10 (host in aten::mm under nsbench.spmm at 5 ms), 40-50 and 55-95
    # (the window alone at 45 ms; aten::item under loss_item at 75 ms)
    assert gaps["nsbench.spmm > aten::mm"] == pytest.approx(0.010)
    assert gaps["nsbench.window"] == pytest.approx(0.010)
    assert gaps["nsbench.gcn.loss_item > aten::item"] == pytest.approx(0.040)


def test_no_window_or_no_device_reads_nothing():
    assert trace.summarize_events([("k", "kernel", 0, 5, 7)]) is None
    assert trace.summarize_events(
        [("nsbench.window", "user_annotation", 0, 5, 1)]) is None
