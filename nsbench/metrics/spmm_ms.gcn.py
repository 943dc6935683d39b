"""spmm_ms.gcn: device milliseconds an epoch of the program's ``execute``
spans, the forward's SpMMs and the backward's on the transpose plan: a
timed call's device time times the calls an epoch."""
from nsbench import program_spans as spans


def read(run):
    per_call, per_epoch = spans.device_ms(("execute",)), \
        spans.calls_per_epoch(run)
    if per_call is None or per_epoch is None:
        return None
    return per_call * per_epoch
