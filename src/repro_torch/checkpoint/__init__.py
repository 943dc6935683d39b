"""Sharded numpy checkpointing: the atomic manifest + ``.npy`` layout of
``repro.checkpoint``, with host numpy only."""
from . import checkpoint
from .checkpoint import all_steps, latest_step, restore, save

__all__ = ["checkpoint", "save", "restore", "all_steps", "latest_step"]
