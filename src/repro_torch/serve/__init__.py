"""Serving: the request-batching SpMM service (bounded admission,
deadlines, quarantine, async compaction, background tunes; see
``SpmmService.health()``).  The reference's LM engine
(``repro.serve.engine``) waits for the LM stack (ROADMAP A-queue 9)."""
from . import spmm_service
from .spmm_service import ADMISSION_POLICIES, ServiceStats, SpmmService

__all__ = ["spmm_service", "ADMISSION_POLICIES", "ServiceStats",
           "SpmmService"]
