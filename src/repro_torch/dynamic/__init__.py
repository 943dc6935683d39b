"""Plan maintenance over evolving sparse matrices (``repro.dynamic``),
single-device: value updates (``update_values``, which lives in
``core.values``), the structural delta sidecar with cost-model compaction
(``DynamicPlan``), and the persistent plan registry (``PlanRegistry``)."""
from . import delta, registry
from .delta import (
    DeltaFringe, DynamicPlan, GraphDelta, build_delta_fringe, update_values,
)
from .registry import PlanRegistry, RegistryError, coo_fingerprint

__all__ = [
    "delta", "registry",
    "DeltaFringe", "DynamicPlan", "GraphDelta", "build_delta_fringe",
    "update_values", "PlanRegistry", "RegistryError", "coo_fingerprint",
]
