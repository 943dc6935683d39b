"""Execution entry points over the executor pipeline.

``execute(plan, b)`` resolves the plan's executor from the bounded cache
and calls it on the plan's leaves: one call runs both engine paths and the
merge.  ``execute_sddmm(plan, x, y)`` does the same for SDDMM over the
plan's pattern.  There is no degrade tier in this port: a ``"cuda"`` plan
launches its kernels or raises.

Both are differentiable in their dense operands on either impl, through
the port of the reference's ``SpMMOperator`` (a ``jax.custom_vjp``): each
is a :class:`torch.autograd.Function` whose backward runs the same
executor, on the transpose plan (:func:`transpose_plan`) for SpMM, and as
two SpMMs over the pattern for SDDMM.  The kernels' outputs carry no graph
of their own, and on ``"torch"`` the plain versions run under the
Function too, so the CPU tests cover the backward the card runs.  No
gradient flows to A's values, as in the reference.
"""
from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import spmm as core_spmm
from ..core.plan_ir import (
    NeutronPlan, SpmmConfig, build_sddmm_maps, plan_leaves,
    sddmm_body_leaves, tag_op, validate_rhs,
)
from ..dynamic import update_values
from ..errors import DispatchError, PlanBuildError
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


def _execute(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    """:func:`execute` without the autograd Function around it."""
    validate_rhs(b, plan.shape)
    _check_device(plan, b)
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


def _execute_sddmm(plan: NeutronPlan, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """:func:`execute_sddmm` without the autograd Function around it."""
    smaps = build_sddmm_maps(plan)
    batch = validate_sddmm_operands(x, y, plan.shape)
    _check_device(plan, x, y)
    _apply_cache_capacity(plan.config)
    if smaps.nnz == 0:
        shape = (0,) if batch is None else (batch, 0)
        return torch.zeros(shape, dtype=torch.float32, device=plan.device)
    sig = tag_op(plan.signature(), "sddmm", smaps.nnz, smaps.nnz_f,
                 plan.config.fringe_vmem_budget)
    fn = build_executor(sig, batch=batch)
    _cache.record_dispatch("sddmm")
    return fn(*sddmm_body_leaves(plan, smaps), x, y, derived=plan.derived)


# --- the backward: transpose plans and the autograd Functions --------------


def transpose_structure(plan: NeutronPlan) -> NeutronPlan:
    """The plan of Aᵀ: ``prepare`` of ``(cols, rows, vals)`` with shape
    ``(K, M)``, the same config and the same device, as the reference's
    ``SpMMOperator.plan_t``.  Its COO is in A's input order, so nonzero
    ``i`` of A is nonzero ``i`` of Aᵀ.

    Built once per structure and cached in ``plan.derived``, which every
    plan that ``update_values`` derives from this one shares: so only the
    structure may be relied on.  Its values are those of the plan that
    first asked; :func:`transpose_plan` gives a plan's own.
    """
    maps = plan.update_maps
    if maps is None:
        raise PlanBuildError(
            "the transpose plan is prepared from the plan's COO; this plan "
            "has no update maps (carry them with "
            "interop.update_maps_from_arrays, or prepare from COO)")
    cached = plan.derived.get("transpose_structure")
    if cached is None:
        m, k = plan.shape
        cached = core_spmm.prepare(maps.cols, maps.rows, maps.vals, (k, m),
                                   plan.config, device=plan.device)
        plan.derived["transpose_structure"] = cached
        # whose values the structure holds: that plan's value array, by
        # identity (update_values gives every updated plan a new array)
        plan.derived["transpose_values_of"] = weakref.ref(maps.vals)
    return cached


def transpose_plan(plan: NeutronPlan) -> NeutronPlan:
    """The plan of Aᵀ with ``plan``'s values.  For the plan whose values
    the cached structure (:func:`transpose_structure`) holds, that
    structure; for another, the structure with its values written in
    (``update_values``), kept for the last such plan in ``plan.derived``
    so that its next backward builds nothing.  Plans are told apart by
    the identity of their value arrays, so no call compares values."""
    structure = transpose_structure(plan)
    derived = plan.derived
    vals = plan.update_maps.vals
    if derived["transpose_values_of"]() is vals:
        return structure
    last = derived.get("transpose_last")
    if last is not None and last[0]() is vals:
        return last[1]
    own = update_values(structure, np.arange(vals.shape[0]), vals)
    derived["transpose_last"] = (weakref.ref(vals), own)
    return own


class SpMMFunction(torch.autograd.Function):
    """``C = A @ B`` with ``dL/dB = Aᵀ @ dL/dC``: both directions run the
    coordinated executor, the backward on :func:`transpose_plan`.  ``b``
    is (K, N) or (batch, K, N)."""

    @staticmethod
    def forward(ctx, b: torch.Tensor, plan: NeutronPlan) -> torch.Tensor:
        ctx.plan = plan
        ctx.b_dtype = b.dtype
        return _execute(plan, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        db = _execute(transpose_plan(ctx.plan), g.contiguous())
        return db.to(ctx.b_dtype), None


def _sddmm_grads(plan: NeutronPlan, x: torch.Tensor, y: torch.Tensor,
                 g: torch.Tensor, need_x: bool, need_y: bool):
    """dX = S_g @ Yᵀ and dY = (S_gᵀ @ X)ᵀ for one (M, D) x, (D, K) y and
    (nnz,) g, where S_g is the pattern carrying g (duplicate entries sum
    in their shared slot, as ``update_values`` writes them)."""
    ids = np.arange(g.shape[0])
    dx = dy = None
    if need_x:
        dx = _execute(update_values(plan, ids, g), y.t().to(torch.float32))
    if need_y:
        at = update_values(transpose_structure(plan), ids, g)
        dy = _execute(at, x.to(torch.float32)).t()
    return dx, dy


class SDDMMFunction(torch.autograd.Function):
    """``out[i] = X[rows[i]] · Y[:, cols[i]]``; its backward is two SpMMs
    over the pattern carrying the incoming gradient (:func:`_sddmm_grads`),
    item by item for batched operands."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, y: torch.Tensor,
                plan: NeutronPlan) -> torch.Tensor:
        ctx.plan = plan
        ctx.save_for_backward(x, y)
        return _execute_sddmm(plan, x, y)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, y = ctx.saved_tensors
        need_x, need_y = ctx.needs_input_grad[:2]
        if not (need_x or need_y):
            return None, None, None
        if g.ndim == 1:
            dx, dy = _sddmm_grads(ctx.plan, x, y, g, need_x, need_y)
        else:
            items = [_sddmm_grads(ctx.plan, xi, yi, gi, need_x, need_y)
                     for xi, yi, gi in zip(x, y, g)]
            dx = torch.stack([d for d, _ in items]) if need_x else None
            dy = torch.stack([d for _, d in items]) if need_y else None
        return (None if dx is None else dx.to(x.dtype),
                None if dy is None else dy.to(y.dtype), None)


def execute(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    """Coordinated SpMM: C = A @ B in original row order, fp32.

    ``b`` is a (K, N) operand or a (batch, K, N) stack of right-hand sides
    (then the result is (batch, M, N)), on the plan's device.
    Differentiable in ``b`` (:class:`SpMMFunction`).
    """
    return SpMMFunction.apply(b, plan)


def execute_sddmm(plan: NeutronPlan, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul over a plan's sparsity pattern.

    Computes ``(X @ Y)[i, j]`` at exactly the pattern's nonzeros and returns
    them as fp32 ``(nnz,)`` (batched operands give ``(batch, nnz)``) in the
    plan's input COO order, the order ``SparseMatrix.with_values`` takes.
    One call runs the dense-tile kernel on the plan's tiles and the gather
    kernel on its fringe.  Differentiable in ``x`` and ``y``
    (:class:`SDDMMFunction`).
    """
    return SDDMMFunction.apply(x, y, plan)


class SpMMOperator:
    """Differentiable fixed-structure SpMM, ``C = A @ B`` with ``dC/dB =
    Aᵀ @ g``: the port of the reference's ``SpMMOperator``.  Both
    directions run the coordinated executor; the transpose has its own
    plan (``plan_t``, partition and reorder of Aᵀ), prepared here as the
    reference prepares it."""

    def __init__(self, rows, cols, vals, shape: Tuple[int, int],
                 config: SpmmConfig = SpmmConfig(), *, device=None):
        self.plan = core_spmm.prepare(np.asarray(rows), np.asarray(cols),
                                      np.asarray(vals), shape, config,
                                      device=device)
        self.plan_t = transpose_plan(self.plan)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return execute(self.plan, b)
