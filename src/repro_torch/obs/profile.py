"""Per-dispatch roofline profiler (opt-in via ``SpmmConfig.telemetry``).

``exec.api`` wraps each dispatch site with the synchronised timing
discipline of ``core.tuner.timed_best_of`` — synchronise the card before
and after the call, so the measurement covers the work, not the enqueue —
and records one :class:`DispatchRecord` here:
measured wall-clock joined with the cost model's FLOP/byte estimates per
(op, tier, plan signature), split by engine path (matrix vs fringe).

The profiler is host-side only and purely additive: it never re-runs an
executor (zero extra launches), never touches the plan signature or the
executor cache key (zero extra builds), and when disabled the dispatch
path does not even synchronise.  Records live in a bounded ring; the
aggregate matrix-path/fringe-path attribution is computed on demand by
``obs.report``.  Each record also feeds two registry metrics
(``obs_profiled_dispatches_total`` and the ``obs_dispatch_us`` histogram)
so the Prometheus export carries dispatch latency without reading the
ring.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY

DEFAULT_PROFILE_CAPACITY = 4096

#: Engine-path keys every record's ``terms`` dict may carry.
PATHS = ("matrix", "fringe")

_DISPATCHES = REGISTRY.counter(
    "obs_profiled_dispatches_total",
    "dispatches measured by the telemetry profiler",
    labelnames=("op", "tier"),
)
_DISPATCH_US = REGISTRY.histogram(
    "obs_dispatch_us",
    "synchronized per-dispatch wall time (us), telemetry-enabled only",
    labelnames=("op", "tier"),
)
_PADDING_WASTE = REGISTRY.gauge(
    "obs_padding_waste",
    "zero fraction of the matrix path's streamed active tiles "
    "(last profiled dispatch; structured formats cut the bytes it wastes)",
    labelnames=("op", "tier"),
)


class DispatchRecord:
    """One measured dispatch: wall time + modeled work per engine path."""

    __slots__ = ("op", "tier", "sig_key", "kind", "measured_us", "traced",
                 "batch", "terms", "peaks", "attrs")

    def __init__(self, *, op: str, tier: str, sig_key: str, kind: str,
                 measured_us: float, traced: bool,
                 batch: Optional[int],
                 terms: Dict[str, Dict[str, float]],
                 peaks: Dict[str, float],
                 attrs: Optional[Dict[str, Any]] = None):
        self.op = op
        self.tier = tier
        self.sig_key = sig_key
        self.kind = kind
        self.measured_us = float(measured_us)
        self.traced = bool(traced)
        self.batch = batch
        # {"matrix": {"flops": .., "bytes": ..}, "fringe": {...}} — absent
        # paths contribute nothing to the attribution
        self.terms = {
            p: {"flops": float(t.get("flops", 0.0)),
                "bytes": float(t.get("bytes", 0.0))}
            for p, t in terms.items() if p in PATHS
        }
        # {"flops_per_s": .., "bytes_per_s": ..} — the roofline ceilings
        # the *caller's* cost model measured/assumed; carried per record so
        # obs never has to import the cost model
        self.peaks = {k: float(v) for k, v in peaks.items()}
        self.attrs = dict(attrs or {})

    def as_dict(self) -> Dict[str, Any]:
        return {
            "op": self.op,
            "tier": self.tier,
            "sig": self.sig_key,
            "kind": self.kind,
            "measured_us": self.measured_us,
            "traced": self.traced,
            "batch": self.batch,
            "terms": {p: dict(t) for p, t in self.terms.items()},
            "peaks": dict(self.peaks),
            "attrs": dict(self.attrs),
        }


class DispatchProfiler:
    """Bounded thread-safe ring of :class:`DispatchRecord`."""

    def __init__(self, capacity: int = DEFAULT_PROFILE_CAPACITY):
        self._lock = threading.Lock()
        self._ring: "deque[DispatchRecord]" = deque(maxlen=int(capacity))

    def record(self, **fields: Any) -> DispatchRecord:
        rec = DispatchRecord(**fields)
        with self._lock:
            self._ring.append(rec)
        _DISPATCHES.inc(op=rec.op, tier=rec.tier)
        _DISPATCH_US.observe(rec.measured_us, op=rec.op, tier=rec.tier)
        if "padding_waste" in rec.attrs:
            _PADDING_WASTE.set(
                float(rec.attrs["padding_waste"]), op=rec.op, tier=rec.tier)
        return rec

    def records(self) -> List[DispatchRecord]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


#: Process-wide profiler the exec layer records into.
PROFILER = DispatchProfiler()
