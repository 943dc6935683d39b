"""prepare_s: host seconds of ``sparse.from_coo`` in set-up (partition,
reorder, reuse order, packing, upload), synchronised at its end."""


def read(run):
    spans = run.spans.get("prepare")
    return spans[0] if spans else None
