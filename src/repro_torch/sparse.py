"""Sparse-operator facade over the port's plan IR.

::

    import repro_torch.sparse as sp

    A = sp.from_coo(rows, cols, vals, shape)   # on the card, impl="cuda"
    C = sp.spmm(A, B)        # (M, N)        = A @ B
    C = sp.bspmm(A, Bb)      # (batch, M, N) = A @ B per batch
    C = A @ B

The subset of ``repro.sparse`` this port carries: static single-device
plans and the SpMM operators.  Entry points run on the card unless the
caller passes ``device="cpu"`` (the plain versions, ``impl="torch"``);
with no CUDA device and no ``device="cpu"`` they raise rather than carry
on on the CPU.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .core import spmm as core_spmm
from .core.plan_ir import NeutronPlan, SpmmConfig
from .errors import PlanBuildError
from .exec import api as _exec

__all__ = ["SparseMatrix", "from_coo", "from_plan", "spmm", "bspmm"]


class SparseMatrix:
    """A prepared sparse matrix: a thin handle over one :class:`NeutronPlan`."""

    __slots__ = ("plan",)

    def __init__(self, plan: NeutronPlan):
        if not isinstance(plan, NeutronPlan):
            raise TypeError(
                f"SparseMatrix wraps a NeutronPlan; got {type(plan).__name__}")
        self.plan = plan

    @property
    def shape(self) -> Tuple[int, int]:
        return self.plan.shape

    @property
    def device(self) -> torch.device:
        return self.plan.device

    @property
    def nnz(self) -> int:
        return self.coo()[0].shape[0]

    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host ``(rows, cols, vals)`` triplets of the matrix."""
        maps = self.plan.update_maps
        if maps is None:
            raise PlanBuildError("plan was built without update maps")
        return maps.rows, maps.cols, maps.vals

    def dense(self) -> np.ndarray:
        """Dense fp64 mirror (duplicates accumulate). Debug/test sized."""
        rows, cols, vals = self.coo()
        out = np.zeros(self.shape, np.float64)
        np.add.at(out, (rows, cols), vals.astype(np.float64))
        return out

    def __matmul__(self, other):
        return spmm(self, other)

    def __repr__(self) -> str:
        return (f"SparseMatrix(shape={self.shape}, device={self.device}, "
                f"impl={self.plan.config.impl!r})")


def from_coo(
    rows,
    cols,
    vals,
    shape: Tuple[int, int],
    *,
    device: Any = "cuda",
    config: Optional[SpmmConfig] = None,
    **config_overrides,
) -> SparseMatrix:
    """Prepare a sparse matrix from COO triplets, on ``device``.

    The impl follows the device unless given: ``"cuda"`` on a CUDA device,
    ``"torch"`` on the CPU.  Pass a full :class:`SpmmConfig` via ``config``
    or individual fields as keyword overrides, not both.
    """
    if config is not None and config_overrides:
        raise ValueError(
            "pass either config= or individual config overrides, not both")
    if config is None:
        impl = config_overrides.pop(
            "impl", "cuda" if torch.device(device).type == "cuda" else "torch")
        config = SpmmConfig(impl=impl, **config_overrides)
    plan = core_spmm.prepare(np.asarray(rows), np.asarray(cols),
                             np.asarray(vals), shape, config, device=device)
    return SparseMatrix(plan)


def from_plan(plan: NeutronPlan) -> SparseMatrix:
    """Adopt an already-prepared plan into the facade."""
    return SparseMatrix(plan)


def _as_matrix(a, what: str) -> SparseMatrix:
    if isinstance(a, SparseMatrix):
        return a
    if isinstance(a, NeutronPlan):
        return SparseMatrix(a)
    raise TypeError(f"{what} wants a SparseMatrix, got {type(a).__name__}")


def spmm(a, b) -> torch.Tensor:
    """Dense ``C = A @ B`` in fp32.  ``b`` is (K, N) on A's device (a
    numpy array is copied there); batched operands go through
    :func:`bspmm`."""
    a = _as_matrix(a, "spmm")
    if isinstance(b, np.ndarray):
        b = torch.from_numpy(b).to(a.device)
    return _exec.execute(a.plan, b)


def bspmm(a, b) -> torch.Tensor:
    """Batched SpMM: ``b`` is (batch, K, N) -> (batch, M, N), one call per
    engine path for the whole batch."""
    if b.ndim != 3:
        raise ValueError(
            f"bspmm wants a (batch, K, N) operand, got ndim={b.ndim} "
            "(use spmm for a single right-hand side)")
    return spmm(a, b)

