"""Shared set-up of the benchmark's CPU tests: the checkout's root and the
program's ``src/`` on the path, the ``gpu`` marker, and a benchmark folder
at a test's size."""
import json
import shutil
import sys
from pathlib import Path

import pytest

NSBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = NSBENCH.parent
for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the cells' graphs and model at a size the CPU runs in a second
TINY = {
    "reddit": {"graph": {"n": 3000, "nonzeros": 120000, "avg_degree": 40.0}},
    "ogbn-arxiv": {"graph": {"n": 2000, "n_classes": 8},
                   "features": 16, "hidden": 32, "classes": 8,
                   "train_nodes": 1100},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device and nvcc (repro_torch kernels); skips "
        "without one")


def tiny_root(dest: Path) -> Path:
    """A copy of the benchmark's folder with the configurations cut to
    ``TINY`` (the mixes, kinds, generators, readers and limits as they
    are)."""
    for d in ("traffic", "kinds", "generators", "metrics", "limits"):
        shutil.copytree(NSBENCH / d, dest / d)
    (dest / "configs").mkdir()
    for name, cut in TINY.items():
        cfg = json.loads((NSBENCH / "configs" / f"{name}.json").read_text())
        cfg["graph"].update(cut["graph"])
        cfg.update({k: v for k, v in cut.items() if k != "graph"})
        (dest / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_bench(tmp_path):
    from nsbench.harness import Bench

    return Bench.load(CHECKOUT / "BENCHMARK.json", tiny_root(tmp_path))
