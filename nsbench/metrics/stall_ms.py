"""stall_ms.<cell's work>: device milliseconds inside the program's
``execute`` spans that none of their stages covers (the card waiting on
the host inside the program), over the window's timed calls: per call
where the window counts calls (``stall_ms.spmm``), per epoch where it
counts epochs (``stall_ms.gcn``)."""
from nsbench import program_spans as spans


def read(run):
    t = spans.totals()
    ex = (t or {}).get("execute", {})
    if not ex.get("timed"):
        return None
    per_call = 1e-6 * ex["stall_ns"] / ex["timed"]
    if run.counters.get("calls"):
        return per_call
    per_epoch = spans.calls_per_epoch(run)
    return None if per_epoch is None else per_call * per_epoch
