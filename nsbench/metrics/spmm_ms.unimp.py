"""spmm_ms.unimp: device milliseconds a forward of the program's
``execute`` spans (the SpMMs, one a head): a timed call's device time
times the calls, over the window's forwards."""
from nsbench import attention_spans


def read(run):
    return attention_spans.per_forward_ms(run, ("execute",))
