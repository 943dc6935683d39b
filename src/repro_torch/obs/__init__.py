"""repro_torch.obs — telemetry: metrics, traces, roofline attribution.

Bottom-of-graph layer (beside ``errors``): imports nothing from the rest of
the package, so every layer may publish into it.  Three surfaces, as in
``repro.obs``:

- :data:`REGISTRY` — the process-wide metrics registry (plan building, the
  executor cache and the profiler record here);
- :data:`TRACES` — the span recorder: rings of completed traces (the
  ``sparse`` facade's calls on telemetry-enabled plans, each SpMM while a
  ``torch.profiler`` session is active, and every plan build) and
  per-span-name totals of host, device and stall time
  (:mod:`repro_torch.obs.trace`);
- :data:`PROFILER` — per-dispatch measurements (telemetry-enabled plans
  only) that :func:`snapshot` aggregates into the matrix-path vs
  fringe-path roofline attribution, against the H100's ceilings.

``snapshot()`` returns the whole state as JSON-serializable dicts
(``traces``, ``build_traces`` and ``span_totals`` are the recorder's);
``prometheus_text()`` emits the Prometheus text exposition (registry
metrics plus roofline gauges) that ``metrics.parse_prometheus_text``
round-trips.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    format_sample,
    get_registry,
    instance_label,
    parse_prometheus_text,
)
from .profile import PATHS, DispatchProfiler, DispatchRecord, PROFILER
from .report import format_report, roofline_attribution, roofline_prometheus
from .trace import (
    NOOP,
    Span,
    Trace,
    TraceStore,
    TRACES,
    profiler_active,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "format_sample",
    "get_registry",
    "instance_label",
    "parse_prometheus_text",
    "PATHS",
    "DispatchProfiler",
    "DispatchRecord",
    "PROFILER",
    "format_report",
    "roofline_attribution",
    "roofline_prometheus",
    "NOOP",
    "Span",
    "Trace",
    "TraceStore",
    "TRACES",
    "profiler_active",
    "snapshot",
    "prometheus_text",
    "roofline",
    "reset_for_tests",
]


def roofline(*, include_traced: bool = False) -> Dict[str, Any]:
    """Matrix-path vs fringe-path attribution over the profiler ring."""
    return roofline_attribution(PROFILER.records(),
                                include_traced=include_traced)


def snapshot(*, trace_limit: Optional[int] = 64,
             include_traced: bool = False) -> Dict[str, Any]:
    """One JSON-serializable dict of all telemetry state.  Reading the
    span totals waits for the calls still on the card."""
    return {
        "metrics": REGISTRY.snapshot(),
        "traces": TRACES.snapshot(trace_limit),
        "build_traces": TRACES.build_snapshot(),
        "span_totals": TRACES.totals(),
        "roofline": roofline(include_traced=include_traced),
    }


def prometheus_text(*, include_traced: bool = False) -> str:
    """Prometheus text exposition: registry metrics + roofline gauges."""
    return (REGISTRY.to_prometheus()
            + roofline_prometheus(roofline(include_traced=include_traced)))


def reset_for_tests() -> None:
    """Zero all metric series and span totals, and drop traces and
    profile records.

    Metric *objects* (and their registrations) survive — modules register
    at import time; only values reset.
    """
    REGISTRY.reset_values()
    TRACES.reset()
    PROFILER.reset()
