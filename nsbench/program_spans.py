"""The program's own spans, read through ``repro_torch.obs``.

``repro_torch.obs.snapshot()`` gives the program's totals per span name
(``span_totals``: ``count`` and ``host_ns`` of every span; ``device_ns``
and ``stall_ns`` of the ``timed`` ones, every few calls on the card) and
its newest plan builds (``build_traces``).  The program keeps per-call
totals only while a profiler session is active, and the harness profiles
the window alone, so the totals are the window's own.  A program that
keeps no such spans, or recorded none, gives None throughout.
"""
from typing import Dict, List, Optional

MERGE = ("permute_b", "matrix_gather", "fringe_gather", "add")


def _snapshot() -> Optional[dict]:
    try:
        import repro_torch.obs as obs
    except ImportError:
        return None
    return obs.snapshot(trace_limit=1)


def totals() -> Optional[Dict[str, Dict[str, int]]]:
    """The program's totals per span name, or None where it has none."""
    snap = _snapshot()
    return (snap or {}).get("span_totals") or None


def builds() -> List[dict]:
    """The program's plan-build traces, newest first ([] where none)."""
    snap = _snapshot()
    return list(reversed((snap or {}).get("build_traces") or []))


def _newest_root(name: str) -> Optional[dict]:
    for tr in builds():
        if tr["spans"] and tr["spans"][0]["name"] == name:
            return tr["spans"][0]
    return None


def prepare_stage_s(stage: str) -> Optional[float]:
    """Host seconds of one stage of the newest ``prepare`` that is not
    part of a transpose plan's build."""
    root = _newest_root("prepare")
    if root is None:
        return None
    us = [c["duration_us"] for c in root["children"] if c["name"] == stage]
    return 1e-6 * sum(us) if us else None


def transpose_s() -> Optional[float]:
    """Host seconds of the newest transpose plan's build."""
    root = _newest_root("transpose_structure")
    return None if root is None else 1e-6 * root["duration_us"]


def device_ms(names) -> Optional[float]:
    """Device milliseconds a call of the named spans, summed: each span's
    device time over the calls the program timed on the card (it times
    every few calls); None where it timed none."""
    t = totals()
    if not t or not t.get("execute", {}).get("timed"):
        return None
    return 1e-6 * sum(t[n]["device_ns"] / t[n]["timed"]
                      for n in names if t.get(n, {}).get("timed"))


def calls_per_epoch(run) -> Optional[float]:
    """The program's ``execute`` spans an epoch of the window."""
    t, epochs = totals(), run.counters.get("epochs")
    if not t or not epochs or "execute" not in t:
        return None
    return t["execute"]["count"] / epochs
