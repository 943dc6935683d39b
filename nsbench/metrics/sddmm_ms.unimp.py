"""sddmm_ms.unimp: device milliseconds a forward of the program's ``sddmm``
spans (B4 and B5 with their operands, batched over a layer's heads): a
timed call's device time times the calls, over the window's forwards."""
from nsbench import attention_spans


def read(run):
    return attention_spans.per_forward_ms(run, ("sddmm",))
