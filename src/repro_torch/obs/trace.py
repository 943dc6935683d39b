"""Spans: the port's one recorder, for requests, calls and plan builds.

A :class:`Trace` is one request's life (a facade operator call, a served
ticket, one SpMM, one plan build); a :class:`Span` is one named phase
inside it, with its parent span's id and the trace's id, so the spans of
a trace form a tree (``Span.children``; ``Trace.spans`` holds its
top-level spans).  Completed traces land in bounded rings: per-call traces
in one (``capacity`` most recent), plan-build traces in a ring of their
own, so that a long run of calls never evicts them.

Two ways to record:

- by hand, with explicit timestamps or the store's clock (:meth:`begin`,
  :meth:`add_span`, :meth:`span`, :meth:`end`), as the serving layer
  traces its tickets on its own clock;
- as the program runs, with context managers that nest on a per-thread
  stack of open spans (:meth:`TraceStore.build`, :meth:`TraceStore.call`,
  :meth:`TraceStore.stage`, :meth:`TraceStore.open`,
  :meth:`TraceStore.request`).  A span opened with nothing open on its
  thread starts a trace; the backward's SpMMs, which run on autograd's
  device thread, start traces of their own there.

Plan-build spans (:meth:`build`) are always recorded: a handful of clock
reads per ``prepare``.  A build span opened inside a per-call trace starts
a build trace of its own, so every plan build lands in the build ring.
Per-call spans (:meth:`call`, and the :meth:`stage` spans inside a call)
are recorded only while a ``torch.profiler`` session is active
(:func:`profiler_active`) or the caller asks for them (a plan's
``telemetry``).  Otherwise a call site costs one test and gets the shared
no-op :data:`NOOP`: no allocation, no clock read, no event, no range.

Every recorded span reads the store's clock at its start and end
(:meth:`TraceStore.now_ns`): by default the clock ``torch.profiler``
stamps host events with, Unix-epoch nanoseconds, so a span lines up with
the profiler's trace; tests inject a deterministic clock
(:meth:`TraceStore.set_clock`).  While a profiler session is active a
recorded span is also a profiler range named ``repro_torch.<name>``: a
``RecordFunction`` opened through ``torch._C._profiler._RecordFunctionFast``
(an operator-scope range, about 1 us on the host, where
``torch.autograd.profiler.record_function``'s user-scope range costs tens
of microseconds under a CUDA trace).

Device time: one in :data:`TIME_EVERY` of the calls a thread opens on a
CUDA device is timed, with each of its stages, by a pair of timing events
on the stream current when the call opened: the start event recorded as
the span opens, the end event as it closes, next to the stage's launches.
Under a CUDA trace each event call costs about 10 us on the host, so
timing every call would slow the host the trace is meant to observe.
Which calls are timed follows the thread's phase, which steps by the
golden ratio's fraction a call (:func:`_time_next`): no model's repeating
sequence of calls aliases with it, so every position in the sequence is
timed at the same rate and a timed call's mean stands for all of them.
Closed calls' pairs are folded into the totals as later calls close (one
``Event.query`` a call, never a wait); the rest are resolved when the
totals are read (:meth:`TraceStore.totals`).  Totals per span name:
``count`` and ``host_ns`` over every recorded span; ``device_ns`` and, on
a call, ``stall_ns`` over the ``timed`` ones.  A call's stall is its
device time that none of its stages covers: before its first stage,
between two stages and after its last, the card waiting on the host
inside the program.  A stage's device time runs from its open to its
close, so it holds the card's idle time while the host works inside the
stage before or between its launches.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

DEFAULT_TRACE_CAPACITY = 512
#: Plan-build traces kept.
DEFAULT_BUILD_CAPACITY = 64
#: One in this many recorded calls of a thread on a CUDA device is timed
#: on the device.
TIME_EVERY = 8
#: The step of a thread's timing phase: the golden ratio's fraction.
_PHASE_STEP = (5 ** 0.5 - 1) / 2
#: Timed calls awaiting their device times: folded once this many have
#: closed, and past the cap the oldest is waited for (the host is then a
#: thousand timed calls ahead of the card).
FOLD_AFTER = 16
MAX_PENDING_CALLS = 1024
#: Prefix of every span's profiler range.
RANGE_PREFIX = "repro_torch."
#: What opens a span's profiler range: a context manager from its name.
_RANGE = torch._C._profiler._RecordFunctionFast

CALL, BUILD = "call", "build"

_SPAN_IDS = itertools.count(1)


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) session is
    recording on this process."""
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    if flag is None:
        return bool(torch.autograd._profiler_enabled())
    return flag


class Span:
    __slots__ = ("name", "start_us", "end_us", "attrs", "span_id",
                 "parent_id", "trace_id", "children")

    def __init__(self, name: str, start_us: float,
                 end_us: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.start_us = float(start_us)
        self.end_us = None if end_us is None else float(end_us)
        self.attrs = dict(attrs or {})
        self.span_id = next(_SPAN_IDS)
        self.parent_id: Optional[int] = None
        self.trace_id: Optional[int] = None
        self.children: List["Span"] = []

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
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "children": [c.as_dict() for c in self.children],
        }


class Trace:
    """One traced request; top-level spans append in completion order."""

    __slots__ = ("trace_id", "name", "attrs", "spans", "start_us", "end_us",
                 "kind", "thread")

    def __init__(self, trace_id: int, name: str, start_us: float,
                 attrs: Optional[Dict[str, Any]] = None, kind: str = CALL):
        self.trace_id = int(trace_id)
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.spans: List[Span] = []
        self.start_us = float(start_us)
        self.end_us: Optional[float] = None
        self.kind = kind
        self.thread = threading.get_ident()

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "kind": self.kind,
            "thread": self.thread,
            "start_us": self.start_us,
            "end_us": self.end_us,
            "attrs": dict(self.attrs),
            "spans": [s.as_dict() for s in self.spans],
        }


class _Noop:
    """What a span site gets when nothing is recorded."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: The shared no-op span.
NOOP = _Noop()


class _Open(Span):
    """A span recorded as the program runs, open on its thread's stack
    until its ``with`` block ends.

    ``parent`` is the frame it opened under, ``call`` the call a stage
    belongs to; ``stream`` where a timed call and its stages record their
    events (None otherwise), and ``pairs`` a timed call's stages' event
    pairs, which wait with the call's own.  Links into the trace tree are
    dropped on close, so a closed trace holds no reference cycle."""

    __slots__ = ("store", "trace", "parent", "call", "prev_call", "t0",
                 "ns", "rf", "ranged", "device", "stream", "ev0", "ev1",
                 "pairs", "publish")

    def __enter__(self) -> "_Open":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.store._close(self, exc_type)
        return False

    @property
    def seconds(self) -> float:
        """Host seconds from open to close (once closed)."""
        return self.ns * 1e-9


class _Frame:
    """A trace open on a thread's stack without a span of its own (a
    facade request): the spans opened inside are its top-level spans."""

    __slots__ = ("store", "trace", "prev_call")

    def __enter__(self) -> "_Frame":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.store._close_frame(self, exc_type)
        return False


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Any] = []
        self.call: Optional[_Open] = None
        self.phase = 0.0   # timing phase of the calls on a CUDA device


def _time_next(local: _Local) -> bool:
    """Step the thread's timing phase; whether the call opening now is
    timed (one call in :data:`TIME_EVERY`)."""
    phase = local.phase + _PHASE_STEP
    if phase >= 1.0:
        phase -= 1.0
    local.phase = phase
    return phase < 1.0 / TIME_EVERY


class TraceStore:
    """Thread-safe rings of completed traces, per-name totals, and the
    recording helpers."""

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY, clock=None):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._ring: "deque[Trace]" = deque(maxlen=int(capacity))
        self._build_ring: "deque[Trace]" = deque(
            maxlen=DEFAULT_BUILD_CAPACITY)
        self._ids = itertools.count()
        self._clock = clock
        self._local = _Local()
        # name -> [count, host ns, device ns, stall ns, timed]
        self._totals: Dict[str, List[int]] = {}
        self._pending: deque = deque()   # closed timed calls
        self._pool: Dict[Any, deque] = {}   # device -> free events

    # -- clock -------------------------------------------------------------
    def set_clock(self, clock) -> None:
        """Inject a deterministic clock (seconds); tests pin span times.
        None restores the profiler's clock."""
        self._clock = clock

    def now_ns(self) -> int:
        """The clock every span reads: Unix-epoch nanoseconds, the clock
        of ``torch.profiler``'s host events, unless one is injected."""
        clock = self._clock
        return time.time_ns() if clock is None else int(round(clock() * 1e9))

    def clock(self) -> float:
        return self.now_ns() * 1e-9

    def now_us(self) -> float:
        return self.now_ns() / 1e3

    # -- traces recorded by hand -------------------------------------------
    def begin(self, name: str, start_us: Optional[float] = None,
              **attrs: Any) -> Trace:
        """Open a trace.  Not visible in snapshots until :meth:`end`."""
        return Trace(next(self._ids), name,
                     self.now_us() if start_us is None else start_us, attrs)

    def add_span(self, trace: Trace, name: str, start_us: float,
                 end_us: float, **attrs: Any) -> Span:
        """Record a completed phase with explicit timestamps (us)."""
        span = Span(name, start_us, end_us, attrs)
        span.trace_id = trace.trace_id
        trace.spans.append(span)
        return span

    @contextmanager
    def span(self, trace: Trace, name: str, **attrs: Any) -> Iterator[Span]:
        """Measure a phase with the store clock."""
        span = Span(name, self.now_us(), None, attrs)
        span.trace_id = trace.trace_id
        try:
            yield span
        finally:
            span.end_us = self.now_us()
            trace.spans.append(span)

    def end(self, trace: Trace, end_us: Optional[float] = None) -> None:
        """Close the trace and publish it to its ring."""
        trace.end_us = self.now_us() if end_us is None else float(end_us)
        with self._lock:
            (self._build_ring if trace.kind == BUILD
             else self._ring).append(trace)

    # -- spans recorded as the program runs ---------------------------------
    def build(self, name: str) -> _Open:
        """A plan-build span: always recorded."""
        return self._open(name, BUILD)

    def call(self, name: str, on: bool, device: Any = None):
        """A per-call span whose stages :meth:`stage` records: recorded
        when ``on`` or while a profiler session is active, else
        :data:`NOOP`.  ``device`` (a ``torch.device``): on a CUDA device
        one call in :data:`TIME_EVERY` is timed there with its stages."""
        if not (on or profiler_active()):
            return NOOP
        return self._open(name, CALL, device=device, is_call=True)

    def stage(self, name: str):
        """A stage of the call open on this thread, or :data:`NOOP` where
        no recorded call is open."""
        call = self._local.call
        if call is None:
            return NOOP
        return self._open(name, CALL, call=call)

    def open(self, name: str) -> _Open:
        """A per-call span the caller has already decided to record."""
        return self._open(name, CALL)

    def request(self, name: str, **attrs: Any) -> _Frame:
        """A trace with no span of its own (a facade request): the spans
        opened inside are its top-level spans; on close its ``outcome``
        is ``"ok"`` or the exception's type name."""
        frame = _Frame()
        frame.store, frame.prev_call = self, self._local.call
        frame.trace = Trace(next(self._ids), name, self.now_us(), attrs)
        self._local.stack.append(frame)
        return frame

    def _close_frame(self, frame: _Frame, exc_type) -> None:
        self._pop(frame)
        frame.trace.attrs["outcome"] = ("ok" if exc_type is None
                                        else exc_type.__name__)
        self.end(frame.trace)

    def _pop(self, op) -> None:
        local = self._local
        stack = local.stack
        if stack and stack[-1] is op:
            stack.pop()
        elif op in stack:
            stack.remove(op)
        local.call = op.prev_call

    def _open(self, name: str, kind: str, device: Any = None,
              call: Optional[_Open] = None, is_call: bool = False) -> _Open:
        """Open a span: a stage of ``call``, a call (``is_call``: the
        stages opened inside are its), or a plain span."""
        local = self._local
        stack = local.stack
        parent = stack[-1] if stack else None
        if parent is not None and kind == BUILD and parent.trace.kind != BUILD:
            parent = None   # every plan build lands in the build ring
        op = _Open.__new__(_Open)
        op.name, op.attrs, op.children = name, {}, []
        op.span_id, op.end_us = next(_SPAN_IDS), None
        op.store, op.parent, op.call = self, parent, call
        op.prev_call = local.call
        if parent is None:
            trace = Trace(next(self._ids), name, 0.0, None, kind)
            op.parent_id, op.publish = None, True
        else:
            trace = parent.trace
            op.parent_id = (parent.span_id if parent.__class__ is _Open
                            else None)
            op.publish = False
        op.trace, op.trace_id = trace, trace.trace_id
        op.device = op.stream = op.ev0 = None
        if call is not None:   # a stage: ranged and timed as its call is
            ranged = call.ranged
            if call.stream is not None:
                op.device, op.stream = call.device, call.stream
        else:
            ranged = profiler_active()
            if is_call:
                local.call = op
                if (device is not None and device.type == "cuda"
                        and _time_next(local)):
                    op.device = device
                    op.stream = torch.cuda.current_stream(device)
                    op.pairs = []
        op.ranged = ranged
        op.rf = None
        if ranged:
            op.rf = _RANGE(RANGE_PREFIX + name)
            op.rf.__enter__()
        stack.append(op)
        op.t0 = self.now_ns()
        op.start_us = op.t0 / 1e3
        if parent is None:
            trace.start_us = op.start_us
        if op.stream is not None:
            op.ev0 = self._event(op.device)
            op.ev0.record(op.stream)
        return op

    def _close(self, op: _Open, exc_type) -> None:
        stream = op.stream
        ev1 = None
        if stream is not None:
            ev1 = self._event(op.device)
            ev1.record(stream)
        t1 = self.now_ns()
        if op.rf is not None:
            op.rf.__exit__(None, None, None)
            op.rf = None
        self._pop(op)
        trace, parent, call = op.trace, op.parent, op.call
        op.end_us = t1 / 1e3
        if exc_type is not None:
            op.attrs["error"] = exc_type.__name__
        ns = op.ns = t1 - op.t0
        if parent.__class__ is _Open:
            parent.children.append(op)
        else:
            trace.spans.append(op)
        op.trace = op.parent = op.call = op.prev_call = None
        timed_call = ev1 is not None and call is None
        with self._lock:
            tot = self._totals.get(op.name)
            if tot is None:
                tot = self._totals[op.name] = [0, 0, 0, 0, 0]
            tot[0] += 1
            tot[1] += ns
            if timed_call:
                op.ev1 = ev1
                self._pending.append(op)
        if op.publish:
            self.end(trace, op.end_us)
        if ev1 is None:
            return
        if call is not None:
            call.pairs.append((op.ev0, ev1, op.name))
            op.ev0 = op.stream = None
        elif len(self._pending) >= FOLD_AFTER:
            if len(self._pending) > MAX_PENDING_CALLS:
                self._pending[0].ev1.synchronize()
            self._fold(wait=False)

    # -- device time --------------------------------------------------------
    def _event(self, device) -> "torch.cuda.Event":
        free = self._pool.get(device)
        if free:
            try:
                return free.pop()
            except IndexError:   # taken by another thread meanwhile
                pass
        return torch.cuda.Event(enable_timing=True)

    def _fold(self, wait: bool) -> None:
        """Fold closed timed calls' event pairs into the totals, oldest
        first, with one query a call (its stages end before it on its
        stream); with ``wait``, wait for every pending call."""
        with self._lock:
            pending, totals = self._pending, self._totals
            while pending:
                call = pending[0]
                if wait:
                    call.ev1.synchronize()
                elif not call.ev1.query():
                    break
                pending.popleft()
                pool = self._pool.setdefault(call.device, deque())
                stage_ns = 0
                for ev0, ev1, name in call.pairs:
                    ns = int(round(ev0.elapsed_time(ev1) * 1e6))
                    tot = totals.setdefault(name, [0, 0, 0, 0, 0])
                    tot[2] += ns
                    tot[4] += 1
                    stage_ns += ns
                    pool.extend((ev0, ev1))
                ns = int(round(call.ev0.elapsed_time(call.ev1) * 1e6))
                tot = totals.setdefault(call.name, [0, 0, 0, 0, 0])
                tot[2] += ns
                tot[3] += max(ns - stage_ns, 0)
                tot[4] += 1
                pool.extend((call.ev0, call.ev1))
                call.pairs = call.ev0 = call.ev1 = call.stream = None

    def totals(self) -> Dict[str, Dict[str, int]]:
        """Per span name: ``count`` and ``host_ns`` of every recorded span;
        ``device_ns``, ``stall_ns`` and their ``timed`` count of those
        timed on the card, with every pending call resolved first (a wait
        for the calls still on the card)."""
        self._fold(wait=True)
        with self._lock:
            return {name: {"count": t[0], "host_ns": t[1],
                           "device_ns": t[2], "stall_ns": t[3],
                           "timed": t[4]}
                    for name, t in self._totals.items()}

    def reset_totals(self) -> None:
        """Zero the totals and drop pending calls' event pairs."""
        with self._lock:
            self._totals.clear()
            self._pending.clear()

    # -- views -------------------------------------------------------------
    def recent(self, n: Optional[int] = None) -> List[Trace]:
        with self._lock:
            traces = list(self._ring)
        return traces if n is None else traces[-n:]

    def recent_builds(self, n: Optional[int] = None) -> List[Trace]:
        with self._lock:
            traces = list(self._build_ring)
        return traces if n is None else traces[-n:]

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        return [t.as_dict() for t in self.recent(limit)]

    def build_snapshot(self, limit: Optional[int] = None
                       ) -> List[Dict[str, Any]]:
        return [t.as_dict() for t in self.recent_builds(limit)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def reset(self) -> None:
        """Drop every trace and zero the totals."""
        with self._lock:
            self._ring.clear()
            self._build_ring.clear()
        self.reset_totals()


#: Process-wide recorder the port records into.
TRACES = TraceStore()

