"""Architecture registry: full configs, smoke configs (CPU-runnable), and
the shape-cell definitions.  A copy of ``repro.configs.base`` over the
port's ``ModelConfig``.

Every assigned arch ships ``full`` (the exact published numbers) and
``smoke`` (a reduced same-family config for CPU tests).  ``SHAPES`` defines
the four assigned input-shape cells; ``applicable`` encodes the spec'd
skips (decode for encoder-only, long_500k for quadratic-attention archs).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    full: ModelConfig
    smoke: ModelConfig
    # per-shape training microbatch counts (activation-memory control)
    microbatches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # serve-time KV cache dtype ("bf16" | "int8") — int8 for cells whose
    # bf16 cache exceeds pod HBM (nemotron-class decode)
    kv_cache_dtype: str = "bf16"
    notes: str = ""

    def applicable(self, shape: str) -> Tuple[bool, str]:
        cell = SHAPES[shape]
        if cell.kind == "decode" and self.full.encoder_only:
            return False, "encoder-only arch has no decode step"
        if shape == "long_500k" and not self.full.sub_quadratic:
            return False, "full quadratic attention at 500k context"
        return True, ""


_REGISTRY: Dict[str, Callable[[], ArchDef]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ArchDef:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)
