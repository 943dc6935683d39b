"""Execution entry points over the executor pipeline.

``execute(plan, b)`` resolves the plan's executor from the bounded cache
and calls it on the plan's leaves: one call runs both engine paths and the
merge.  ``execute_sddmm(plan, x, y)`` does the same for SDDMM over the
plan's pattern.  There is no degrade tier in this port: a ``"cuda"`` plan
launches its kernels or raises.

The ``"cuda"`` operators have no backward yet (the reference's
``SpMMOperator``, a ``jax.custom_vjp``): their kernels write outputs that
carry no autograd graph.  So a ``"cuda"`` call made in grad mode with an
operand that requires grad raises :class:`~repro_torch.errors.
NotPortedError` (:func:`check_no_grad`) instead of returning a result
whose gradient would silently be missing.  ``"torch"`` calls keep
PyTorch's graph through the plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.plan_ir import (
    NeutronPlan, SpmmConfig, build_sddmm_maps, plan_leaves,
    sddmm_body_leaves, tag_op, validate_rhs,
)
from ..errors import DispatchError, NotPortedError
from . import cache as _cache
from .cache import (  # noqa: F401  (re-exported test hooks)
    dispatch_count, fused_trace_count, set_executor_cache_capacity,
)
from .pipeline import build_executor


def _apply_cache_capacity(config: SpmmConfig) -> None:
    if config.executor_cache_capacity is not None:
        _cache.EXECUTOR_CACHE.set_capacity(config.executor_cache_capacity)


def _check_device(plan: NeutronPlan, *operands: torch.Tensor) -> None:
    for x in operands:
        if x.device != plan.device:
            raise DispatchError(
                f"operand is on {x.device} but the plan's leaves are on "
                f"{plan.device}; move it there first")


def check_no_grad(impl: str, op: str, *operands) -> None:
    """Raise where ``impl`` is ``"cuda"``, grad mode is on and an operand
    requires grad: the kernels would drop the gradient."""
    if impl != "cuda" or not torch.is_grad_enabled():
        return
    if any(isinstance(x, torch.Tensor) and x.requires_grad
           for x in operands):
        raise NotPortedError(
            f"{op} on impl='cuda' has no backward yet (SpMMOperator, a "
            f"torch.autograd.Function over the kernels, is not ported): "
            f"an operand requires grad, and the kernels would drop its "
            f"gradient.  Call it under torch.no_grad() or on detached "
            f"operands, or use impl='torch' on the CPU.")


def execute(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    """Coordinated SpMM: C = A @ B in original row order, fp32.

    ``b`` is a (K, N) operand or a (batch, K, N) stack of right-hand sides
    (then the result is (batch, M, N)), on the plan's device.
    """
    validate_rhs(b, plan.shape)
    _check_device(plan, b)
    check_no_grad(plan.config.impl, "spmm", b)
    _apply_cache_capacity(plan.config)
    batch = int(b.shape[0]) if b.ndim == 3 else None
    fn = build_executor(plan.signature(), batch=batch)
    _cache.record_dispatch("fused" if batch is None else "batched")
    return fn(*plan_leaves(plan), b, derived=plan.derived,
              a_flag=plan.a_unsplittable)


def validate_sddmm_operands(
    x: torch.Tensor, y: torch.Tensor, shape: Tuple[int, int]
) -> Optional[int]:
    """Validate SDDMM operands against the pattern's shape; returns batch.

    ``x`` is ``(M, D)`` or ``(batch, M, D)``; ``y`` is ``(D, K)`` or
    ``(batch, D, K)``.  Mixed batching is rejected.
    """
    m, k = shape
    if x.ndim not in (2, 3) or y.ndim not in (2, 3):
        raise ValueError(
            f"sddmm operands must be (M, D)/(D, K) or batched with one "
            f"leading axis each; got x {tuple(x.shape)}, y {tuple(y.shape)}")
    if x.ndim != y.ndim:
        raise ValueError(
            f"sddmm operands must be batched together; got x "
            f"{tuple(x.shape)} and y {tuple(y.shape)}")
    if x.ndim == 3 and int(x.shape[0]) != int(y.shape[0]):
        raise ValueError(
            f"sddmm batch sizes disagree: x {tuple(x.shape)} vs y "
            f"{tuple(y.shape)}")
    if int(x.shape[-2]) != m:
        raise ValueError(
            f"sddmm operand M={int(x.shape[-2])} does not match the "
            f"pattern's M={m} (pattern shape {shape})")
    if int(y.shape[-1]) != k:
        raise ValueError(
            f"sddmm operand K={int(y.shape[-1])} does not match the "
            f"pattern's K={k} (pattern shape {shape})")
    if int(x.shape[-1]) != int(y.shape[-2]):
        raise ValueError(
            f"sddmm operands disagree on D: x {tuple(x.shape)} vs y "
            f"{tuple(y.shape)}")
    return int(x.shape[0]) if x.ndim == 3 else None


def execute_sddmm(plan: NeutronPlan, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul over a plan's sparsity pattern.

    Computes ``(X @ Y)[i, j]`` at exactly the pattern's nonzeros and returns
    them as fp32 ``(nnz,)`` (batched operands give ``(batch, nnz)``) in the
    plan's input COO order, the order ``SparseMatrix.with_values`` takes.
    One call runs the dense-tile kernel on the plan's tiles and the gather
    kernel on its fringe.
    """
    smaps = build_sddmm_maps(plan)
    batch = validate_sddmm_operands(x, y, plan.shape)
    _check_device(plan, x, y)
    check_no_grad(plan.config.impl, "sddmm", x, y)
    _apply_cache_capacity(plan.config)
    if smaps.nnz == 0:
        shape = (0,) if batch is None else (batch, 0)
        return torch.zeros(shape, dtype=torch.float32, device=plan.device)
    sig = tag_op(plan.signature(), "sddmm", smaps.nnz, smaps.nnz_f,
                 plan.config.fringe_vmem_budget)
    fn = build_executor(sig, batch=batch)
    _cache.record_dispatch("sddmm")
    return fn(*sddmm_body_leaves(plan, smaps), x, y, derived=plan.derived)
