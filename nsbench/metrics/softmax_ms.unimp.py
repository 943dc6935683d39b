"""softmax_ms.unimp: device milliseconds a forward of the program's
``edge_softmax`` spans (the segment max, exponent, segment sum and
divide of every head of a layer): a timed call's device time times the
calls, over the window's forwards."""
from nsbench import attention_spans


def read(run):
    return attention_spans.per_forward_ms(run, ("edge_softmax",))
