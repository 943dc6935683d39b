"""On the card: one short run of each cell through the benchmark's
command (`nsbench/run.py`), with a correct result line and a trace that
saw the device."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ogbn-arxiv.spmm", "ogbn-arxiv.gcn_train"])
@pytest.mark.parametrize("traced", [0, 1])
def test_short_run_on_the_card(card, cell, traced):
    out = subprocess.run(
        [sys.executable, "nsbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", str(traced)],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu"
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
