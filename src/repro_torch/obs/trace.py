"""Per-request tracing: spans in a bounded ring, deterministic clock.

A :class:`Trace` is one request's life (a facade operator call; the
reference's serving layer, not yet ported, traces its tickets the same
way); a :class:`Span` is one named phase inside it — the ``sparse``
facade records one ``dispatch`` span per call.  Completed traces land in
a ring buffer (``capacity`` most recent; older requests age out, so
tracing is O(capacity) memory in a long-lived process, like every other
observability surface here).

Timestamps come from an injectable clock (seconds, monotonic by
convention); callers that already own an injectable clock pass explicit
timestamps instead.  Tests pin span structure *exactly* by injecting a
deterministic counter clock.

Host-side only: nothing here touches device state.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

DEFAULT_TRACE_CAPACITY = 512


class Span:
    __slots__ = ("name", "start_us", "end_us", "attrs")

    def __init__(self, name: str, start_us: float,
                 end_us: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.start_us = float(start_us)
        self.end_us = None if end_us is None else float(end_us)
        self.attrs = dict(attrs or {})

    @property
    def duration_us(self) -> Optional[float]:
        if self.end_us is None:
            return None
        return self.end_us - self.start_us

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "start_us": self.start_us,
            "end_us": self.end_us,
            "duration_us": self.duration_us,
            "attrs": dict(self.attrs),
        }


class Trace:
    """One traced request; spans append in completion order."""

    __slots__ = ("trace_id", "name", "attrs", "spans", "start_us", "end_us")

    def __init__(self, trace_id: int, name: str, start_us: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = int(trace_id)
        self.name = name
        self.attrs = dict(attrs or {})
        self.spans: List[Span] = []
        self.start_us = float(start_us)
        self.end_us: Optional[float] = None

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "start_us": self.start_us,
            "end_us": self.end_us,
            "attrs": dict(self.attrs),
            "spans": [s.as_dict() for s in self.spans],
        }


class TraceStore:
    """Thread-safe ring of completed traces + span recording helpers."""

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._ring: "deque[Trace]" = deque(maxlen=int(capacity))
        self._next_id = 0
        self._clock = clock

    # -- clock -------------------------------------------------------------
    def set_clock(self, clock) -> None:
        """Inject a deterministic clock (seconds); tests pin span times."""
        self._clock = clock

    def clock(self) -> float:
        return self._clock()

    def now_us(self) -> float:
        return self._clock() * 1e6

    # -- trace lifecycle ---------------------------------------------------
    def begin(self, name: str, start_us: Optional[float] = None,
              **attrs: Any) -> Trace:
        """Open a trace.  Not visible in snapshots until :meth:`end`."""
        with self._lock:
            trace_id = self._next_id
            self._next_id += 1
        return Trace(
            trace_id, name,
            self.now_us() if start_us is None else start_us, attrs,
        )

    def add_span(self, trace: Trace, name: str, start_us: float,
                 end_us: float, **attrs: Any) -> Span:
        """Record a completed phase with explicit timestamps (us)."""
        span = Span(name, start_us, end_us, attrs)
        trace.spans.append(span)
        return span

    @contextmanager
    def span(self, trace: Trace, name: str, **attrs: Any) -> Iterator[Span]:
        """Measure a phase with the store clock."""
        start = self.now_us()
        span = Span(name, start, None, attrs)
        try:
            yield span
        finally:
            span.end_us = self.now_us()
            trace.spans.append(span)

    def end(self, trace: Trace, end_us: Optional[float] = None) -> None:
        """Close the trace and publish it to the ring."""
        trace.end_us = self.now_us() if end_us is None else float(end_us)
        with self._lock:
            self._ring.append(trace)

    # -- views -------------------------------------------------------------
    def recent(self, n: Optional[int] = None) -> List[Trace]:
        with self._lock:
            traces = list(self._ring)
        return traces if n is None else traces[-n:]

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        return [t.as_dict() for t in self.recent(limit)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


#: Process-wide trace ring the facade records into.
TRACES = TraceStore()
