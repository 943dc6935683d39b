"""Thread-safe metrics registry: counters, gauges, bounded histograms.

The port of ``repro.obs.metrics``: the single home for every count the
port emits (plan building, the executor cache, the telemetry profiler).
Design constraints:

- **Thread-safe.**  Every metric mutation and every snapshot takes the
  registry lock; a snapshot is a consistent point-in-time view even while
  dispatch/compaction/tuning threads are mutating.
- **Labels, bounded.**  Series are keyed by label values.  Each metric has
  a cardinality cap (``max_series``); once a metric is at its cap, *new*
  label sets collapse into a single overflow series (label values
  ``"__other__"``) and ``dropped_series()`` counts the drop — a
  misbehaving label (say, a request id) degrades the metric, never memory.
- **Counters only go up** (``reset`` is an explicit test/lifecycle hook);
  gauges are set; histograms have *fixed, finite* bucket bounds chosen at
  registration (plus the implicit +Inf), so a series costs O(buckets),
  never O(observations).
- **Idempotent registration.**  ``registry.counter("x", ...)`` returns the
  existing metric when names collide with identical type/labels, and
  raises on a conflicting re-registration — module-level handles stay
  valid across reloads and test re-imports.

The registry imports nothing from the rest of the package, so it sits at
the bottom of the layer graph and every layer may use it.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_MAX_SERIES = 1024

#: Label values new series collapse into once a metric is at its cap.
OVERFLOW_LABEL = "__other__"

#: Default latency-style buckets (microseconds): 10us .. ~10s.
DEFAULT_US_BUCKETS = (
    10.0, 100.0, 1_000.0, 10_000.0, 100_000.0, 1_000_000.0, 10_000_000.0,
)

_INSTANCE_SEQ = itertools.count()


def instance_label(prefix: str) -> str:
    """Process-unique label value for per-instance series (``svc3``, ...).

    Objects that used to own private counters (a ``ServiceStats``, a
    ``HealthTable``) keep per-instance semantics on the shared registry by
    labelling their series with one of these.
    """
    return f"{prefix}{next(_INSTANCE_SEQ)}"


class _Metric:
    """Base: name, labelnames, bounded series map.  Lock lives on the
    registry so multi-metric snapshots are consistent."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str], max_series: Optional[int]):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _slot(self, labels: Dict[str, Any], default) -> Tuple[str, ...]:
        """Existing-or-new series key, collapsing past the cardinality cap.

        Caller holds the lock.
        """
        key = self._key(labels)
        if key in self._series:
            return key
        if self.max_series is not None and len(self._series) >= self.max_series:
            self._registry._note_dropped(self.name)
            key = tuple(OVERFLOW_LABEL for _ in self.labelnames)
        self._series.setdefault(key, default() if callable(default) else default)
        return key

    def labelsets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(zip(self.labelnames, k)) for k in self._series]

    def reset(self, **labels: Any) -> None:
        """Drop one series (with labels) or every series (without)."""
        with self._lock:
            if labels:
                self._series.pop(self._key(labels), None)
            else:
                self._series.clear()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "type": self.kind,
                "help": self.help,
                "labelnames": list(self.labelnames),
                "series": [
                    {"labels": dict(zip(self.labelnames, k)),
                     "value": self._series_value(v)}
                    for k, v in sorted(self._series.items())
                ],
            }

    def _series_value(self, raw: Any) -> Any:
        return raw


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels: Any) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} can only increase (inc {n})")
        with self._lock:
            key = self._slot(labels, 0.0)
            self._series[key] += n

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))

    def series(self) -> Dict[Tuple[str, ...], float]:
        """{label-value tuple: count} for every live series."""
        with self._lock:
            return {k: float(v) for k, v in self._series.items()}


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        with self._lock:
            key = self._slot(labels, 0.0)
            self._series[key] = float(v)

    def inc(self, n: float = 1, **labels: Any) -> None:
        with self._lock:
            key = self._slot(labels, 0.0)
            self._series[key] += n

    def dec(self, n: float = 1, **labels: Any) -> None:
        self.inc(-n, **labels)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bound, non-cumulative
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bound histogram; the implicit +Inf bucket is always last."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames, max_series,
                 buckets: Sequence[float] = DEFAULT_US_BUCKETS):
        super().__init__(registry, name, help, labelnames, max_series)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket bound")
        self.buckets = bounds

    def observe(self, v: float, **labels: Any) -> None:
        v = float(v)
        with self._lock:
            key = self._slot(labels, lambda: _HistSeries(len(self.buckets) + 1))
            s = self._series[key]
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    s.counts[i] += 1
                    break
            else:
                s.counts[-1] += 1
            s.sum += v
            s.count += 1

    def _series_value(self, raw: _HistSeries) -> Dict[str, Any]:
        cum, total = [], 0
        for c in raw.counts:
            total += c
            cum.append(total)
        return {
            "buckets": dict(zip([*map(str, self.buckets), "+Inf"], cum)),
            "sum": raw.sum,
            "count": raw.count,
        }


class MetricsRegistry:
    """Named metrics with one shared lock; snapshots are consistent."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: "Dict[str, _Metric]" = {}
        self._dropped: Dict[str, int] = {}  # metric name -> dropped series

    # -- registration ------------------------------------------------------
    def _register(self, cls, name: str, help: str, labelnames, max_series,
                  **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                return existing
            metric = cls(self, name, help, labelnames, max_series, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                max_series: Optional[int] = DEFAULT_MAX_SERIES) -> Counter:
        return self._register(Counter, name, help, labelnames, max_series)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              max_series: Optional[int] = DEFAULT_MAX_SERIES) -> Gauge:
        return self._register(Gauge, name, help, labelnames, max_series)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_US_BUCKETS,
                  max_series: Optional[int] = DEFAULT_MAX_SERIES) -> Histogram:
        return self._register(Histogram, name, help, labelnames, max_series,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def _note_dropped(self, name: str) -> None:
        # caller holds the lock
        self._dropped[name] = self._dropped.get(name, 0) + 1

    def dropped_series(self) -> Dict[str, int]:
        """Per-metric count of label sets collapsed past the cap."""
        with self._lock:
            return dict(self._dropped)

    # -- views -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time consistent view of every metric."""
        with self._lock:
            out = {name: m.snapshot() for name, m in sorted(
                self._metrics.items())}
            if self._dropped:
                out["__dropped_series__"] = dict(self._dropped)
            return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition of every metric."""
        with self._lock:
            lines: List[str] = []
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {_escape_help(m.help)}")
                lines.append(f"# TYPE {name} {m.kind}")
                snap = m.snapshot()
                for s in snap["series"]:
                    labels, value = s["labels"], s["value"]
                    if m.kind == "histogram":
                        for bound, cum in value["buckets"].items():
                            lines.append(format_sample(
                                f"{name}_bucket", {**labels, "le": bound},
                                cum))
                        lines.append(format_sample(
                            f"{name}_sum", labels, value["sum"]))
                        lines.append(format_sample(
                            f"{name}_count", labels, value["count"]))
                    else:
                        lines.append(format_sample(name, labels, value))
            return "\n".join(lines) + "\n" if lines else ""

    # -- lifecycle ---------------------------------------------------------
    def reset_values(self, names: Optional[Iterable[str]] = None) -> None:
        """Zero every series (metric objects stay registered).  Test hook."""
        with self._lock:
            targets = self._metrics.values() if names is None else [
                self._metrics[n] for n in names if n in self._metrics]
            for m in targets:
                m._series.clear()
            if names is None:
                self._dropped.clear()


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_sample(name: str, labels: Dict[str, Any], value: Any) -> str:
    """One Prometheus text sample line (shared with the roofline export)."""
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(str(v))}"' for k, v in sorted(
                labels.items())
        )
        return f"{name}{{{body}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


def _format_value(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def parse_prometheus_text(text: str) -> Dict[str, Dict[Tuple, float]]:
    """Parse exposition text back into ``{name: {label-items: value}}``.

    The inverse of :meth:`MetricsRegistry.to_prometheus` /
    :func:`format_sample`, used by the round-trip tests.  Label items are
    sorted
    ``(key, value)`` tuples.
    """
    out: Dict[str, Dict[Tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, labels, value = _parse_sample(line)
        out.setdefault(name, {})[labels] = value
    return out


def _parse_sample(line: str) -> Tuple[str, Tuple, float]:
    if "{" in line:
        name, rest = line.split("{", 1)
        body, tail = rest.rsplit("}", 1)
        items = []
        for part in _split_labels(body):
            k, v = part.split("=", 1)
            v = v.strip()[1:-1]  # strip quotes
            v = (v.replace('\\"', '"').replace("\\n", "\n")
                 .replace("\\\\", "\\"))
            items.append((k.strip(), v))
        return name.strip(), tuple(sorted(items)), float(tail.strip())
    name, value = line.rsplit(None, 1)
    return name.strip(), (), float(value)


def _split_labels(body: str) -> List[str]:
    parts, buf, in_str, esc = [], [], False, False
    for ch in body:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_str = not in_str
            buf.append(ch)
            continue
        if ch == "," and not in_str:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in (s.strip() for s in parts) if p]


#: The process-wide registry every subsystem publishes into.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
