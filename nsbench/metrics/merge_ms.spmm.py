"""merge_ms.spmm: device milliseconds a call of the program's merge: the
``permute_b``, ``matrix_gather``, ``fringe_gather`` and ``add`` stages
(PyTorch's gathers, ``where``, adds and copies), from their CUDA event
pairs over the window's timed calls."""
from nsbench import program_spans as spans


def read(run):
    return spans.device_ms(spans.MERGE)
