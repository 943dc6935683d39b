"""Serving: the LM engine (``ServeEngine``: prefill + greedy decode over a
KV/SSM cache) and the request-batching SpMM service (bounded admission,
deadlines, quarantine, async compaction, background tunes; see
``SpmmService.health()``)."""
from . import engine, spmm_service
from .engine import ServeConfig, ServeEngine
from .spmm_service import ADMISSION_POLICIES, ServiceStats, SpmmService

__all__ = ["engine", "spmm_service", "ServeConfig", "ServeEngine",
           "ADMISSION_POLICIES", "ServiceStats", "SpmmService"]
