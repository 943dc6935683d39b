"""Execution entry point over the executor pipeline.

``execute(plan, b)`` resolves the plan's executor from the bounded cache
and calls it on the plan's leaves: one call runs both engine paths and the
merge.  There is no degrade tier in this port: a ``"cuda"`` plan launches
its kernels or raises.
"""
from __future__ import annotations

import torch

from ..core.plan_ir import NeutronPlan, SpmmConfig, plan_leaves, validate_rhs
from ..errors import DispatchError
from . import cache as _cache
from .cache import (  # noqa: F401  (re-exported test hooks)
    dispatch_count, fused_trace_count, set_executor_cache_capacity,
)
from .pipeline import build_executor


def _apply_cache_capacity(config: SpmmConfig) -> None:
    if config.executor_cache_capacity is not None:
        _cache.EXECUTOR_CACHE.set_capacity(config.executor_cache_capacity)


def execute(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    """Coordinated SpMM: C = A @ B in original row order, fp32.

    ``b`` is a (K, N) operand or a (batch, K, N) stack of right-hand sides
    (then the result is (batch, M, N)), on the plan's device.
    """
    validate_rhs(b, plan.shape)
    if b.device != plan.device:
        raise DispatchError(
            f"operand is on {b.device} but the plan's leaves are on "
            f"{plan.device}; move it there first")
    _apply_cache_capacity(plan.config)
    batch = int(b.shape[0]) if b.ndim == 3 else None
    fn = build_executor(plan.signature(), batch=batch)
    _cache.record_dispatch("fused" if batch is None else "batched")
    return fn(*plan_leaves(plan), b, derived=plan.derived)
