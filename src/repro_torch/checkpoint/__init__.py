"""Sharded numpy checkpointing: the atomic manifest + ``.npy`` layout of
``repro.checkpoint``, with host numpy only."""
from . import checkpoint
from .checkpoint import (
    all_steps, latest_step, restore, restore_resharded, save,
)

__all__ = ["checkpoint", "save", "restore", "restore_resharded",
           "all_steps", "latest_step"]
