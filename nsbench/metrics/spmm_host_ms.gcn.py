"""spmm_host_ms.gcn: host milliseconds an epoch of the program's
``execute`` spans, on the main thread (the forward) and on autograd's
device thread (the backward), from entry to return, no synchronisation."""
from nsbench import program_spans as spans


def read(run):
    t = spans.totals()
    epochs = run.counters.get("epochs")
    if not t or not epochs or "execute" not in t:
        return None
    return 1e-6 * t["execute"]["host_ns"] / epochs
