"""The configuration ``reddit-gnn`` and its two cells at a test's size on
the CPU: the generator (``chung_lu``'s graph plus the diagonal, the
normalised values, the labels), the attention counts against hand counts,
the new kind and metrics found by name, sound runs, the TF32 control and
every fault failing a limit, and the readers of the program's attention
spans.  On the card (``gpu``): both cells at a test's size."""
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nsbench import attention_spans, control, counts, counts_attention
from nsbench import faults, program_spans
from nsbench.harness import Bench, load_module, run_cell
from nsbench.tests.conftest import tiny_root

NSBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = NSBENCH.parent
CELLS = ("reddit.gcn_train", "reddit.unimp_forward")
FAULTS = {"reddit.gcn_train": ("unchanged", "half_batch", "altered"),
          "reddit.unimp_forward": ("stale_values", "no_gate")}
# reddit-gnn at a size the CPU runs in a second: the GCN's and UniMP's
# shapes, narrower (UniMP's last layer keeps an odd head width)
TINY = {"graph": {"n": 1500, "nonzeros": 40000, "avg_degree": 26.0,
                  "classes": 7},
        "features": 24, "hidden": 32, "classes": 7, "train_nodes": 900,
        "unimp": {"num_layers": 3, "heads": 4, "hidden": 32}}


@pytest.fixture
def tiny_bench(tmp_path):
    """The benchmark at a test's size (``conftest.tiny_root``), with
    ``reddit-gnn`` cut to ``TINY``."""
    root = tiny_root(tmp_path)
    cfg = json.loads((NSBENCH / "configs" / "reddit-gnn.json").read_text())
    cfg["graph"].update(TINY["graph"])
    cfg.update({k: v for k, v in TINY.items() if k != "graph"})
    (root / "configs" / "reddit-gnn.json").write_text(json.dumps(cfg))
    return Bench.load(CHECKOUT / "BENCHMARK.json", root)


def test_generator_adds_the_diagonal_to_chung_lu():
    g = {"n": 700, "nonzeros": 9000, "avg_degree": 12.9, "skew": 1.05,
         "seed": 10, "classes": 41}
    cpu = torch.device("cpu")
    r0, c0, _, _, _ = load_module(
        NSBENCH / "generators" / "chung_lu.py").build(g, cpu)
    rows, cols, vals, shape, labels = load_module(
        NSBENCH / "generators" / "chung_lu_gcn.py").build(g, cpu)
    n = shape[0]
    assert shape == (700, 700) and rows.size == 9000 + n
    key = np.sort(np.concatenate([r0 * n + c0, np.arange(n) * (n + 1)]))
    assert np.array_equal(rows * n + cols, key)
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    want = (deg[rows] * deg[cols]) ** -0.5
    np.testing.assert_allclose(vals, want, rtol=1e-7)
    assert vals.dtype == np.float32
    assert labels.shape == (n,) and labels.min() >= 0 and labels.max() < 41
    assert len(np.unique(labels)) == 41


def test_configuration_is_reddit_with_the_diagonal():
    cfg = json.loads((NSBENCH / "configs" / "reddit-gnn.json").read_text())
    red = json.loads((NSBENCH / "configs" / "reddit.json").read_text())
    for k in ("n", "nonzeros", "avg_degree", "skew", "seed"):
        assert cfg["graph"][k] == red["graph"][k]
    assert cfg["nonzeros"] == red["nonzeros"] + red["nodes"] == 114848857
    assert cfg["reduced"] == []
    kind = load_module(NSBENCH / "kinds" / "unimp_forward.py")
    known = kind.known_nodes(cfg, cfg["nodes"], torch.device("cpu"))
    assert known.numel() == cfg["train_nodes"] == 153431
    assert bool((known[1:] > known[:-1]).all())
    # 3 layers of 4 heads: 64 wide twice, then the classes
    assert counts_attention.unimp_heads(cfg) == [64] * 8 + [41] * 4


def test_attention_counts_by_hand():
    # Q (5 x 3) and K (4 x 3), 7 nonzeros: operands, pattern, values
    by_hand = (5 + 4) * 3 * 4 + 7 * 4 + 6 * 4 + 7 * 4
    assert counts_attention.sddmm_bytes(5, 4, 7, 3) == by_hand
    assert counts_attention.sddmm_flops(7, 3) == 2 * 7 * 3
    # Reddit with self-loops at a head of 64: the bytes bound it
    m, nnz = 232965, 114848857
    b = 2 * m * 64 * 4 + nnz * 8 + (m + 1) * 4
    assert counts_attention.sddmm_bound_s(m, m, nnz, 64) == pytest.approx(
        b / 3.35e12)
    assert counts_attention.sddmm_bound_s(m, m, nnz, 64) == pytest.approx(
        0.3101e-3, rel=1e-3)
    # one forward's SpMMs: 2 nnz (256 + 256 + 4 x 41)
    heads = [64] * 8 + [41] * 4
    assert counts_attention.unimp_spmm_flops(nnz, heads) == \
        2 * nnz * 676 == pytest.approx(155.28e9, rel=1e-4)
    # one call of 2 heads (Q 5 x 3, K 4 x 3 each): the pattern once, the
    # operands and the values per head
    by_hand = 2 * (5 + 4) * 3 * 4 + (7 * 4 + 6 * 4) + 2 * 7 * 4
    assert counts_attention.sddmm_bytes(5, 4, 7, 3, heads=2) == by_hand
    assert counts_attention.sddmm_flops(7, 3, heads=2) == 2 * 2 * 7 * 3
    # a forward: one call a layer, 4 heads of 64 twice, then 4 of 41
    layers = [(4, 64), (4, 64), (4, 41)]
    per_layer = [(4 * 2 * m * c * 4 + nnz * 4 + (m + 1) * 4 + 4 * nnz * 4)
                 / 3.35e12 for _, c in layers]
    assert counts_attention.unimp_sddmm_bound_s(m, nnz, layers) == \
        pytest.approx(sum(per_layer))
    # the pattern counted once a layer: below the sum of 12 one-head calls
    assert counts_attention.unimp_sddmm_bound_s(m, nnz, layers) < (
        8 * counts_attention.sddmm_bound_s(m, m, nnz, 64)
        + 4 * counts_attention.sddmm_bound_s(m, m, nnz, 41))
    assert counts.spmm_flops(nnz, 41) == 2 * nnz * 41


def test_kind_and_metrics_found_by_name(tiny_bench):
    b = tiny_bench
    kind = b.kind_of("reddit.unimp_forward")
    assert kind is load_module(b.root / "kinds" / "unimp_forward.py")
    assert b.kind_of("reddit.gcn_train") is b.kind("gcn_full_batch")
    for name in ("sddmm_ms.unimp", "softmax_ms.unimp", "values_ms.unimp",
                 "spmm_ms.unimp", "sddmm_roofline.unimp"):
        assert b.reader(name) is load_module(
            b.root / "metrics" / f"{name}.py").read
    assert b.reader("idle_frac.unimp") is b.reader("idle_frac.gcn")
    e2e = {m["name"] for m in b.metrics_of("reddit.unimp_forward",
                                          "end_to_end")}
    assert e2e == {"spmm_gflops", "setup_s"}
    e2e = {m["name"] for m in b.metrics_of("reddit.gcn_train", "end_to_end")}
    assert e2e == {"gcn_epoch_ms", "gcn_epoch_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_bench, cell):
    line = run_cell(tiny_bench, cell, 2 ** 31 + 11, 0.2, False, "cpu")
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]
    line = run_cell(tiny_bench, cell, 2 ** 31 + 12, 0.2, True, "cpu")
    assert line["correct"], line["compared"]
    assert "prepare_s" in line["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(tiny_bench, cell):
    limits = tiny_bench.limits(cell)
    for r in control.control_readings(tiny_bench, cell, [1, 2 ** 31 + 3],
                                      torch.device("cpu")):
        assert any(r[k] > limits[k] for k in limits), r


@pytest.mark.parametrize("cell,fault", [
    (cell, f) for cell, names in FAULTS.items() for f in names])
def test_fault_makes_the_run_incorrect(tiny_bench, cell, fault):
    assert tuple(tiny_bench.kind_of(cell).FAULTS) == FAULTS[cell]
    with faults.planted(tiny_bench, cell, fault):
        line = run_cell(tiny_bench, cell, 17, 0.1, False, "cpu")
    assert not line["correct"], (fault, line["compared"])
    assert run_cell(tiny_bench, cell, 17, 0.1, False, "cpu")["correct"]


def test_span_readers(monkeypatch):
    """Each reader from the program's totals, by hand; None without them."""
    tot = {"sddmm": {"count": 30, "timed": 3, "device_ns": 3e7},
           "sddmm_walk": {"count": 120, "timed": 12, "device_ns": 12e6},
           "sddmm_tiles": {"count": 120, "timed": 12, "device_ns": 6e6},
           "with_values": {"count": 120, "timed": 15, "device_ns": 3e7},
           "edge_softmax": {"count": 30, "timed": 4, "device_ns": 8e6},
           "execute": {"count": 120, "timed": 16, "device_ns": 8e7}}
    run = types.SimpleNamespace(counters={"forwards": 10,
                                          "sddmm_bound_s": 1e-3})
    read = {n: load_module(NSBENCH / "metrics" / f"{n}.py").read
            for n in ("sddmm_ms.unimp", "softmax_ms.unimp",
                      "values_ms.unimp", "spmm_ms.unimp",
                      "sddmm_roofline.unimp")}
    monkeypatch.setattr(program_spans, "totals", lambda: tot)
    # sddmm: 10 ms a timed call x 30 calls / 10 forwards
    assert read["sddmm_ms.unimp"](run) == pytest.approx(30.0)
    assert read["softmax_ms.unimp"](run) == pytest.approx(6.0)
    assert read["values_ms.unimp"](run) == pytest.approx(24.0)
    assert read["spmm_ms.unimp"](run) == pytest.approx(60.0)
    # B4 and B5: (1 + 0.5) ms a head x 120 = 0.18 s; bound 10 x 1 ms
    assert attention_spans.window_device_s(
        ("sddmm_walk", "sddmm_tiles")) == pytest.approx(0.18)
    assert read["sddmm_roofline.unimp"](run) == pytest.approx(
        100 * 1e-2 / 0.18)
    monkeypatch.setattr(program_spans, "totals", lambda: None)
    assert all(r(run) is None for r in read.values())


def test_reference_loads_neither_jax_nor_the_program():
    script = (f"import json, sys; sys.path[:0] = [{str(CHECKOUT)!r}]; "
              "import nsbench.reference_unimp, nsbench.counts_attention; "
              "print(json.dumps(sorted({n.split('.')[0] "
              "for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_short_run_on_the_card(card, tiny_bench, cell, traced):
    line = run_cell(tiny_bench, cell, 2 ** 31 + 99, 1.0, traced, "cuda")
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu"
    if traced and cell == "reddit.unimp_forward":
        m = line["metrics"]
        for name in ("sddmm_ms.unimp", "softmax_ms.unimp",
                     "values_ms.unimp", "spmm_ms.unimp",
                     "idle_frac.unimp", "prepare_s"):
            assert m[name]["value"] >= 0, name
        assert 0 < m["sddmm_roofline.unimp"]["value"] <= 100
