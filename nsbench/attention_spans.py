"""The program's attention spans, read per forward through
``program_spans``: the ``sddmm`` calls and their ``sddmm_walk`` (B5) and
``sddmm_tiles`` (B4) stages, ``edge_softmax``, ``with_values`` and the
SpMMs' ``execute``.  A program that keeps none of them gives None."""
from typing import Optional, Sequence

from nsbench import program_spans


def window_device_s(names: Sequence[str]) -> Optional[float]:
    """Device seconds of the named spans over the whole window: each
    name's mean over the calls the program timed on the card, times its
    calls; None where a name was not timed."""
    t = program_spans.totals()
    if not t or not all(t.get(n, {}).get("timed") for n in names):
        return None
    return 1e-9 * sum(t[n]["device_ns"] / t[n]["timed"] * t[n]["count"]
                      for n in names)


def per_forward_ms(run, names: Sequence[str]) -> Optional[float]:
    """Device milliseconds a forward of the named spans."""
    total, forwards = window_device_s(names), run.counters.get("forwards")
    if total is None or not forwards:
        return None
    return 1e3 * total / forwards
