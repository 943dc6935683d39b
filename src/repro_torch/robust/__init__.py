"""Robustness layer: deterministic fault injection for the port.

``repro_torch.robust`` sits next to ``repro_torch.errors`` and
``repro_torch.obs`` at the bottom of the import graph: every layer above
may import it, and it imports nothing but those two.  See ``faults.py``
for the seam catalogue.
"""
from .faults import (
    SEAMS,
    FaultHarness,
    FaultPolicy,
    HARNESS,
    armed,
    chaos_schedule,
)

__all__ = [
    "SEAMS",
    "FaultHarness",
    "FaultPolicy",
    "HARNESS",
    "armed",
    "chaos_schedule",
]
