"""Plan maintenance over evolving sparse matrices (``repro.dynamic``), on
single-device and sharded plans: value updates (``update_values``, which
lives in ``core.values``), the structural delta sidecar with cost-model
compaction (``DynamicPlan``), the persistent plan registry
(``PlanRegistry``), and the tuner table's store over it (``tuning``)."""
from . import delta, registry, tuning
from .delta import (
    DeltaFringe, DynamicPlan, GraphDelta, ShardedDeltaFringe,
    build_delta_fringe, build_sharded_delta_fringe, update_values,
)
from .registry import PlanRegistry, RegistryError, coo_fingerprint

__all__ = [
    "delta", "registry", "tuning",
    "DeltaFringe", "DynamicPlan", "GraphDelta", "ShardedDeltaFringe",
    "build_delta_fringe", "build_sharded_delta_fringe", "update_values",
    "PlanRegistry", "RegistryError", "coo_fingerprint",
]
