"""Bounded executor cache + pipeline observability hooks.

One process-wide LRU holds every built executor, keyed by (signature,
batch), so repeated calls on one plan structure reuse one executor and
capacity eviction bounds memory in a long-lived process.  PyTorch runs
eagerly, so "building" an executor is resolving the plan signature into a
fused-body closure; a build is the counterpart of the reference's trace.

Counts live on the ``repro_torch.obs`` registry:

- ``exec_traces_total{kind}``        — executor builds (``fused`` for a
  (K, N) operand, ``batched`` for (batch, K, N), ``sharded`` for a
  sharded plan's);
- ``exec_dispatches_total{kind}``    — executor invocations by ``exec.api``;
- ``exec_cache_events_total{event}`` — cache ``hit`` / ``miss`` /
  ``eviction``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable

from ..errors import PlanBuildError
from ..obs import REGISTRY

DEFAULT_EXECUTOR_CACHE_CAPACITY = 256

_TRACES = REGISTRY.counter(
    "exec_traces_total", "executor builds (the eager analogue of a trace)",
    labelnames=("kind",))
_DISPATCHES = REGISTRY.counter(
    "exec_dispatches_total", "executor dispatches issued by exec.api",
    labelnames=("kind",))
_CACHE_EVENTS = REGISTRY.counter(
    "exec_cache_events_total", "executor-cache hits/misses/evictions",
    labelnames=("event",))


class ExecutorCache:
    """A thread-safe LRU of built executors keyed by their full build key."""

    def __init__(self, capacity: int = DEFAULT_EXECUTOR_CACHE_CAPACITY):
        if capacity < 1:
            raise PlanBuildError(
                f"cache capacity must be >= 1, got {capacity}")
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._capacity = int(capacity)
        self._lock = threading.Lock()

    @property
    def hits(self) -> int:
        return int(_CACHE_EVENTS.value(event="hit"))

    @property
    def misses(self) -> int:
        return int(_CACHE_EVENTS.value(event="miss"))

    @property
    def evictions(self) -> int:
        return int(_CACHE_EVENTS.value(event="eviction"))

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, capacity: int) -> None:
        if capacity < 1:
            raise PlanBuildError(
                f"cache capacity must be >= 1, got {capacity}")
        with self._lock:
            self._capacity = int(capacity)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._data) > self._capacity:
            self._data.popitem(last=False)
            _CACHE_EVENTS.inc(event="eviction")

    def get_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                _CACHE_EVENTS.inc(event="hit")
                return self._data[key]
        # build outside the lock: builders only close over static metadata,
        # so a racing double-build costs a duplicate closure, never a wrong
        # executor
        fn = builder()
        with self._lock:
            if key not in self._data:
                _CACHE_EVENTS.inc(event="miss")
                self._data[key] = fn
                self._evict_locked()
            self._data.move_to_end(key)
            return self._data[key]

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._data


EXECUTOR_CACHE = ExecutorCache()


def set_executor_cache_capacity(capacity: int) -> None:
    """Resize the process-wide executor cache (evicts LRU entries)."""
    EXECUTOR_CACHE.set_capacity(capacity)


def fused_trace_count() -> int:
    """Number of executor builds, of either kind, since process start
    (test hook)."""
    return int(_TRACES.total())


def sharded_trace_count() -> int:
    """Number of sharded-executor builds since process start (test hook)."""
    return int(_TRACES.value(kind="sharded"))


def dispatch_count() -> int:
    """Number of executor dispatches issued by ``exec.api`` (test hook)."""
    return int(_DISPATCHES.total())


def record_build(kind: str) -> None:
    _TRACES.inc(kind=kind)


def record_dispatch(kind: str) -> None:
    _DISPATCHES.inc(kind=str(kind))
