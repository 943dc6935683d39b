"""Thread-safe metrics registry: labelled counters with bounded series.

The part of ``repro.obs.metrics`` that plan building and the executor
cache publish to.  Every mutation and every snapshot takes the registry
lock, so a snapshot is a consistent point-in-time view.  Each metric has a
cardinality cap (``max_series``): once it is reached, *new* label sets
collapse into one overflow series (label values ``"__other__"``), so a
misbehaving label degrades the metric, never memory.  Registration is
idempotent: ``registry.counter("x", ...)`` returns the existing counter
when name and labels match and raises on a conflicting re-registration.

Imports nothing from the rest of the package, so every layer may use it.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

DEFAULT_MAX_SERIES = 1024

#: Label values new series collapse into once a metric is at its cap.
OVERFLOW_LABEL = "__other__"


class Counter:
    """A monotonically increasing count per label set."""

    kind = "counter"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str], max_series: Optional[int]):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._series: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _slot(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        """Existing-or-new series key, collapsing past the cap (locked)."""
        key = self._key(labels)
        if key in self._series:
            return key
        if self.max_series is not None and len(self._series) >= self.max_series:
            self._registry._note_dropped(self.name)
            key = tuple(OVERFLOW_LABEL for _ in self.labelnames)
        self._series.setdefault(key, 0.0)
        return key

    def inc(self, n: float = 1, **labels: Any) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} can only increase (inc {n})")
        with self._lock:
            self._series[self._slot(labels)] += n

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "type": self.kind,
                "help": self.help,
                "labelnames": list(self.labelnames),
                "series": [
                    {"labels": dict(zip(self.labelnames, k)), "value": v}
                    for k, v in sorted(self._series.items())
                ],
            }


class MetricsRegistry:
    """Named counters with one shared lock; snapshots are consistent."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, Counter] = {}
        self._dropped: Dict[str, int] = {}  # metric name -> dropped series

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                max_series: Optional[int] = DEFAULT_MAX_SERIES) -> Counter:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{existing.labelnames}"
                    )
                return existing
            metric = Counter(self, name, help, labelnames, max_series)
            self._metrics[name] = metric
            return metric

    def get(self, name: str) -> Optional[Counter]:
        with self._lock:
            return self._metrics.get(name)

    def _note_dropped(self, name: str) -> None:
        # caller holds the lock
        self._dropped[name] = self._dropped.get(name, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time consistent view of every metric."""
        with self._lock:
            out = {name: m.snapshot()
                   for name, m in sorted(self._metrics.items())}
            if self._dropped:
                out["__dropped_series__"] = dict(self._dropped)
            return out

    def reset_values(self, names: Optional[Iterable[str]] = None) -> None:
        """Zero every series (metric objects stay registered).  Test hook."""
        with self._lock:
            targets = self._metrics.values() if names is None else [
                self._metrics[n] for n in names if n in self._metrics]
            for m in targets:
                m._series.clear()
            if names is None:
                self._dropped.clear()


REGISTRY = MetricsRegistry()
