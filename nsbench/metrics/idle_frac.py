"""idle_frac.<cell's work>: the share of the traced window in which no
kernel, copy or memset ran on the card."""


def read(run):
    return None if run.trace is None else run.trace.idle_frac
