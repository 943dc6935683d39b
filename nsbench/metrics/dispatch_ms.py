"""dispatch_ms.<cell's work>: host milliseconds from the entry of one
call into the program to its return, with no synchronisation, averaged
over the window (``dispatch_ms.spmm``: one ``sparse.spmm``;
``dispatch_ms.gcn``: one epoch's step, the forward, the backward through
autograd and the transpose plan and the optimizer, up to the wait in
``loss.item()``)."""
import statistics


def read(run):
    spans = run.spans.get("dispatch")
    return 1e3 * statistics.fmean(spans) if spans else None
