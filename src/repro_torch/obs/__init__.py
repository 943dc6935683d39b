"""repro_torch.obs — the process-wide metrics registry.

Bottom-of-graph layer (beside ``errors``): imports nothing from the rest of
the package.  Plan building and the executor cache publish their counters
into :data:`REGISTRY`.
"""
from __future__ import annotations

from .metrics import REGISTRY, Counter, MetricsRegistry

__all__ = ["REGISTRY", "Counter", "MetricsRegistry"]
