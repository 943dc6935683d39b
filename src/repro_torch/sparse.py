"""Sparse-operator facade over the port's plan IR.

::

    import repro_torch.sparse as sp

    A = sp.from_coo(rows, cols, vals, shape)   # on the card, impl="cuda"
    C = sp.spmm(A, B)        # (M, N)        = A @ B
    C = sp.bspmm(A, Bb)      # (batch, M, N) = A @ B per batch
    C = A @ B
    w = sp.sddmm(A, X, Y)    # (nnz,) values of X @ Y at A's pattern
    A2 = A.with_values(w)    # same pattern, new values, same executor

    W = sp.from_coo(rows, cols, vals, shape, structure_hint=("nm", 2, 4))
    Y = W @ X                # a 2:4-pruned weight on the N:M kernel

The subset of ``repro.sparse`` this port carries: static single-device
plans (general, N:M and bitmap payloads), SpMM, SDDMM and value updates.
``spmm``/``bspmm`` are differentiable in B and ``sddmm`` in X and Y, on
either impl (``exec.api.SpMMFunction`` and ``SDDMMFunction``: the
backward runs the same executor, on the transpose plan for SpMM); no
gradient flows to A's values, as in the reference.  ``A @ A`` on two
sparse handles (the reference's ``spspmm``) raises
:class:`~repro_torch.errors.NotPortedError`.
``sddmm`` returns values in the input COO order of the pattern, the order
``with_values`` takes, so GAT-style attention is three calls: ``sddmm``
-> ``with_values`` -> ``spmm``.  Entry points run on the card unless the caller passes
``device="cpu"`` (the plain versions, ``impl="torch"``); with no CUDA
device and no ``device="cpu"`` they raise rather than carry on on the CPU.
With ``telemetry=True`` in the config, each ``spmm``/``bspmm``/``sddmm``
call records a trace with one ``dispatch`` span in ``obs.TRACES`` (and its
executor dispatch a roofline record in ``obs.PROFILER``); read them with
``repro_torch.obs.snapshot()``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .core import spmm as core_spmm
from .core.plan_ir import NeutronPlan, SpmmConfig
from .dynamic import update_values
from .errors import NotPortedError, PlanBuildError
from .exec import api as _exec
from .obs import TRACES

__all__ = ["SparseMatrix", "from_coo", "from_plan", "spmm", "bspmm",
           "sddmm"]


def _traced_call(name: str, plan: NeutronPlan, attrs, fn):
    """Run ``fn()``; when the plan opts into telemetry, record an
    ``obs`` trace with one ``dispatch`` span around it (host-side
    bookkeeping only: with telemetry off this is the bare call)."""
    if not plan.config.telemetry:
        return fn()
    tr = TRACES.begin(f"facade:{name}", **attrs)
    t0 = TRACES.now_us()
    try:
        out = fn()
    except BaseException as err:
        TRACES.add_span(tr, "dispatch", t0, TRACES.now_us())
        tr.attrs["outcome"] = type(err).__name__
        TRACES.end(tr)
        raise
    TRACES.add_span(tr, "dispatch", t0, TRACES.now_us())
    tr.attrs["outcome"] = "ok"
    TRACES.end(tr)
    return out


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

    @property
    def row(self) -> np.ndarray:
        return self.coo()[0]

    @property
    def col(self) -> np.ndarray:
        return self.coo()[1]

    @property
    def val(self) -> np.ndarray:
        return self.coo()[2]

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

    def with_values(self, values) -> "SparseMatrix":
        """Same pattern, new per-nonzero values (input COO order), as a
        numpy array or a tensor: the landing pad for :func:`sddmm` output.

        Functional: returns a new handle and leaves this one as it was.
        The plan signature, and so the cached executor, is unchanged
        (``dynamic.update_values`` underneath).
        """
        nnz = self.nnz
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        if tuple(values.shape) != (nnz,):
            raise ValueError(
                f"with_values needs one value per nonzero: got shape "
                f"{tuple(values.shape)} for nnz={nnz}")
        return SparseMatrix(update_values(self.plan, np.arange(nnz), values))

    def __matmul__(self, other):
        if isinstance(other, (SparseMatrix, NeutronPlan)):
            raise NotPortedError(
                "SparseMatrix @ SparseMatrix is spspmm, which the port does "
                "not carry yet; multiply by a dense operand (spmm)")
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
    or individual fields as keyword overrides, not both: for example
    ``structure_hint=("nm", 2, 4)`` or ``structure_hint="bitmap"`` for a
    pruned weight (an N:M pattern is also detected without a hint).
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


def _on_device(x, a: SparseMatrix) -> torch.Tensor:
    """A numpy operand copied to A's device; a tensor as it is."""
    return torch.from_numpy(x).to(a.device) if isinstance(x, np.ndarray) else x


def spmm(a, b) -> torch.Tensor:
    """Dense ``C = A @ B`` in fp32.  ``b`` is (K, N) on A's device (a
    numpy array is copied there); batched operands go through
    :func:`bspmm`.  Differentiable in ``b``: its gradient is ``Aᵀ @ g``,
    run on the transpose plan."""
    a = _as_matrix(a, "spmm")
    b = _on_device(b, a)
    return _traced_call(
        "bspmm" if b.ndim == 3 else "spmm", a.plan,
        {"shape": a.shape, "n": int(b.shape[-1])},
        lambda: _exec.execute(a.plan, b))


def bspmm(a, b) -> torch.Tensor:
    """Batched SpMM: ``b`` is (batch, K, N) -> (batch, M, N), one call per
    engine path for the whole batch."""
    if b.ndim != 3:
        raise ValueError(
            f"bspmm wants a (batch, K, N) operand, got ndim={b.ndim} "
            "(use spmm for a single right-hand side)")
    return spmm(a, b)


def sddmm(a, x, y) -> torch.Tensor:
    """Sampled dense-dense matmul: the values of ``X @ Y`` at A's pattern.

    ``x`` is (M, D) and ``y`` (D, K), or both with a leading batch axis, on
    A's device (numpy arrays are copied there).  Returns (nnz,) fp32 values
    ((batch, nnz) when batched) in the input COO order of ``a``, ready for
    ``a.with_values``.  Differentiable in ``x`` and ``y``: with ``S_g`` the
    pattern carrying the incoming gradient, ``dX = S_g @ Yᵀ`` and ``dY =
    (S_gᵀ @ X)ᵀ``, two SpMMs.
    """
    a = _as_matrix(a, "sddmm")
    x, y = _on_device(x, a), _on_device(y, a)
    return _traced_call("sddmm", a.plan, {"shape": a.shape},
                        lambda: _exec.execute_sddmm(a.plan, x, y))
