"""matrix_ms.spmm: device milliseconds a call of the program's ``matrix``
stage (B1, or the N:M or bitmap kernel, with its non-finite check), from
its CUDA event pairs over the window's timed calls."""
from nsbench import program_spans as spans


def read(run):
    return spans.device_ms(("matrix",))
