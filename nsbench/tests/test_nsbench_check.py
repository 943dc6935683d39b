"""What decides ``correct``, driven through whole runs at a test's size on
the CPU (the program's plain versions, the harness's check of a card
skipped): sound runs pass, the TF32 control fails the limits, and every
fault a cell can have turns ``correct`` false."""
import pytest
import torch

from nsbench import control, faults
from nsbench.harness import run_cell

CELLS = ("reddit.spmm", "ogbn-arxiv.spmm", "ogbn-arxiv.gcn_train")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_bench, cell):
    line = run_cell(tiny_bench, cell, 2 ** 31 + 11, 0.2, False, "cpu")
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "compared"
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(tiny_bench, cell):
    limits = tiny_bench.limits(cell)
    for r in control.control_readings(tiny_bench, cell, [1, 2, 2 ** 31 + 3],
                                      torch.device("cpu")):
        assert any(r[k] > limits[k] for k in limits), r


FAULTS = {"reddit.spmm": ("stale", "half_rows", "altered"),
          "ogbn-arxiv.gcn_train": ("unchanged", "half_batch", "altered")}


def test_each_kind_lists_its_faults(tiny_bench):
    for cell, names in FAULTS.items():
        assert tuple(tiny_bench.kind_of(cell).FAULTS) == names


@pytest.mark.parametrize("cell,fault", [
    (cell, f) for cell, names in FAULTS.items() for f in names])
def test_fault_makes_the_run_incorrect(tiny_bench, cell, fault):
    with faults.planted(tiny_bench, cell, fault):
        line = run_cell(tiny_bench, cell, 17, 0.1, False, "cpu")
    assert not line["correct"], (fault, line["compared"])
    # and the program is whole again after
    assert run_cell(tiny_bench, cell, 17, 0.1, False, "cpu")["correct"]
