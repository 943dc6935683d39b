"""The yardstick's arithmetic against hand counts."""
import statistics

import pytest

from nsbench import counts

REDDIT = dict(m=232965, k=232965, nnz=70525725, n=256)
ARXIV = dict(m=169343, k=169343, nnz=2481327, n=256)


def test_spmm_counts_reddit():
    # values and int32 columns per nonzero, m + 1 offsets, B and C once
    by_hand = 70525725 * 8 + 232966 * 4 + 2 * 232965 * 256 * 4
    assert counts.spmm_bytes(**REDDIT) == by_hand
    assert by_hand == pytest.approx(1.0422e9, rel=1e-4)
    assert counts.spmm_flops(70525725, 256) == 2 * 70525725 * 256
    # bytes bound it: 1.0422 GB / 3.35 TB/s = 0.311 ms
    assert counts.spmm_bound_s(**REDDIT) == pytest.approx(by_hand / 3.35e12)
    assert counts.spmm_bound_s(**REDDIT) == pytest.approx(0.311e-3, rel=2e-3)


def test_spmm_counts_arxiv():
    by_hand = 2481327 * 8 + 169344 * 4 + 2 * 169343 * 256 * 4
    assert counts.spmm_bytes(**ARXIV) == by_hand
    assert by_hand == pytest.approx(367.3e6, rel=1e-3)
    assert counts.spmm_bound_s(**ARXIV) == pytest.approx(0.1096e-3,
                                                         rel=2e-3)


def test_compute_bound_where_flops_dominate():
    # a dense row block: 1e6 nonzeros in 10 rows, N = 4096
    t = counts.spmm_bound_s(10, 1000, 10 ** 6, 4096)
    assert t == counts.spmm_flops(10 ** 6, 4096) / 495e12


def test_gcn_epoch_flops_arxiv():
    # OGB's GCN: 128 -> 256 -> 256 -> 40
    f = counts.gcn_epoch_flops(169343, 2481327, [128, 256, 256, 40])
    n, nnz = 169343, 2481327
    fwd = (2 * n * 128 * 256 + 2 * nnz * 256
           + 2 * n * 256 * 256 + 2 * nnz * 256
           + 2 * n * 256 * 40 + 2 * nnz * 40)
    bwd = (2 * nnz * 256 + 2 * n * 128 * 256                       # layer 1
           + 2 * nnz * 256 + 2 * n * 256 * 256 + 2 * n * 256 * 256  # layer 2
           + 2 * nnz * 40 + 2 * n * 256 * 40 + 2 * n * 256 * 40)    # layer 3
    assert f["forward"] == fwd and f["backward"] == bwd
    assert f["forward"] == pytest.approx(39.50e9, rel=1e-3)
    assert f["backward"] == pytest.approx(65.17e9, rel=1e-3)
    assert f["epoch"] == pytest.approx(104.67e9, rel=1e-3)


def test_gcn_epoch_flops_two_layers():
    # the two-layer form: 128 -> 256 -> 40, as a plain count
    f = counts.gcn_epoch_flops(169343, 2481327, [128, 256, 40])
    assert f["forward"] == pytest.approx(16.04e9, rel=1e-3)
    assert f["backward"] == pytest.approx(19.50e9, rel=1e-3)


def test_gflops_over_the_window():
    # 550 Reddit calls in a 10 s window
    flops = counts.spmm_flops(70525725, 256)
    assert counts.gflops(flops, 550, 10.0) == pytest.approx(
        flops * 550 / 10.0 / 1e9)
    assert counts.gflops(flops, 550, 10.0) == pytest.approx(1986.0,
                                                            rel=1e-3)


def test_p95_of_synthetic_epochs():
    # 1,000 epochs of 9 ms with every twentieth at 12 ms: the 95th
    # percentile sits at the edge of the slow ones
    times = [0.012 if i % 20 == 0 else 0.009 for i in range(1000)]
    assert counts.p95(times) == pytest.approx(
        statistics.quantiles(times, n=100)[94])
    assert 0.009 <= counts.p95(times) <= 0.012
    assert counts.p95(list(range(1, 101))) == pytest.approx(95.95)
    assert counts.p95([0.5]) == 0.5


def test_peaks_are_the_published_h100_rates():
    assert counts.PEAKS == {"hbm_bytes_per_s": 3.35e12,
                            "tf32_flops_per_s": 495e12}
