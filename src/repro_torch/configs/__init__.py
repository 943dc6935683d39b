"""Assigned-architecture registry (``--arch <id>``); the arch files are
copies of ``repro.configs``'s, field for field."""
from . import (  # noqa: F401  (registration side effects)
    gemma2_9b,
    granite_34b,
    granite_moe_3b_a800m,
    hubert_xlarge,
    llama4_scout_17b_a16e,
    mamba2_1p3b,
    nemotron_4_340b,
    phi_3_vision_4p2b,
    qwen1p5_4b,
    zamba2_1p2b,
)
from .base import SHAPES, ArchDef, ShapeCell, get_arch, list_archs

__all__ = ["SHAPES", "ArchDef", "ShapeCell", "get_arch", "list_archs"]
