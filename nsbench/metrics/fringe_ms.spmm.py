"""fringe_ms.spmm: device milliseconds a call of the program's ``fringe``
stage (B2 or B3), from its CUDA event pairs over the window's timed
calls."""
from nsbench import program_spans as spans


def read(run):
    return spans.device_ms(("fringe",))
