"""Sparse-operator facade over the port's plan IR.

::

    import repro_torch.sparse as sp

    A = sp.from_coo(rows, cols, vals, shape)   # on the card, impl="cuda"
    C = sp.spmm(A, B)        # (M, N)        = A @ B
    C = sp.bspmm(A, Bb)      # (batch, M, N) = A @ B per batch
    C = A @ B
    w = sp.sddmm(A, X, Y)    # (nnz,) values of X @ Y at A's pattern
    A2 = A.with_values(w)    # same pattern, new values, same executor
    P = sp.spspmm(A, A)      # sparse x sparse, a new SparseMatrix
    P = A @ A
    C = sp.spmm(A, B, deadline=0.5)   # DeadlineExceeded if it lands late

    W = sp.from_coo(rows, cols, vals, shape, structure_hint=("nm", 2, 4))
    Y = W @ X                # a 2:4-pruned weight on the N:M kernel

    D = sp.from_coo(rows, cols, vals, shape, dynamic=True)
    D.plan.update(GraphDelta.inserts(r, c, v))   # structural mutation
    C = D @ B                # base plan + delta sidecar, one call
    D.plan.compact()         # fold the sidecar into a fresh plan

    mesh = make_spmm_mesh(devices=["cuda:0"] * 4)  # or every card
    S = sp.from_coo(rows, cols, vals, shape, mesh=mesh)  # sharded plan
    C = sp.spmm(S, B)        # B on mesh.first; one launch set per shard

What this port carries of ``repro.sparse``: single-device plans (general,
N:M and bitmap payloads) and sharded ones (``core.spmm.prepare_sharded``
over a ``distributed.SpmmMesh``), static or dynamic
(``dynamic.DynamicPlan``), SpMM, SDDMM, sparse x sparse products
(``spspmm``; a product of sharded inputs is prepared on one device) and
value updates.  ``with_values``, ``sddmm`` and
``spspmm`` address the prepared pattern, so on a dynamic matrix with
pending structural deltas they raise until ``compact()``, as in the
reference.
``spmm``/``bspmm`` are differentiable in B and ``sddmm`` in X and Y, on
either impl (``exec.api.SpMMFunction`` and ``SDDMMFunction``: the
backward runs the same executor, on the transpose plan for SpMM); no
gradient flows to A's values, as in the reference.
``sddmm`` returns values in the input COO order of the pattern, the order
``with_values`` takes, so GAT-style attention is three calls: ``sddmm``
-> ``with_values`` -> ``spmm``.  Entry points run on the card unless the caller passes
``device="cpu"`` (the plain versions, ``impl="torch"``); with no CUDA
device and no ``device="cpu"`` they raise rather than carry on on the CPU.
Every operator takes ``deadline=`` (seconds): the call synchronises the
result's device, then raises :class:`~repro_torch.errors.DeadlineExceeded`
if it finished later than that after it started (a post-hoc check, as in
the reference; the work is not cancelled).
With ``telemetry=True`` in the config, each ``spmm``/``bspmm``/``sddmm``/
``spspmm`` call records a trace with one ``dispatch`` span in ``obs.TRACES`` (and its
executor dispatch a roofline record in ``obs.PROFILER``); read them with
``repro_torch.obs.snapshot()``.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .core import spmm as core_spmm
from .core.plan_ir import NeutronPlan, ShardedPlan, SpmmConfig
from .dynamic import DynamicPlan, update_values
from .errors import DeadlineExceeded, PlanBuildError
from .exec import api as _exec
from .obs import TRACES

__all__ = ["SparseMatrix", "from_coo", "from_plan", "spmm", "bspmm",
           "sddmm", "spspmm"]


PlanLike = Union[NeutronPlan, ShardedPlan, DynamicPlan]


def _traced_call(name: str, plan: PlanLike, attrs, fn):
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


def _await(out: torch.Tensor, deadline: Optional[float], t0: float,
           what: str) -> torch.Tensor:
    """Post-hoc deadline: synchronise ``out``'s device, then raise if the
    call landed too late.  The counterpart of the reference's
    ``jax.block_until_ready``: a clock read without the synchronisation
    would time only the enqueue."""
    if deadline is None:
        return out
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    elapsed = time.monotonic() - t0
    if elapsed > deadline:
        raise DeadlineExceeded(
            f"{what} finished {elapsed - deadline:.3f}s past its "
            f"{deadline:.3f}s deadline")
    return out


class SparseMatrix:
    """A prepared sparse matrix: a thin handle over one
    :class:`NeutronPlan` or :class:`ShardedPlan`, or a
    :class:`~repro_torch.dynamic.DynamicPlan` (mutable) over either."""

    __slots__ = ("plan",)

    def __init__(self, plan: PlanLike):
        if not isinstance(plan, (NeutronPlan, ShardedPlan, DynamicPlan)):
            raise TypeError(
                "SparseMatrix wraps a NeutronPlan, ShardedPlan or "
                f"DynamicPlan; got {type(plan).__name__}")
        self.plan = plan

    def _static_plan(self, what: str) -> NeutronPlan:
        """The underlying static plan; a dynamic plan with pending
        structural deltas has left its prepared pattern, so
        pattern-addressed operators refuse it."""
        p = self.plan
        if isinstance(p, DynamicPlan):
            if p.delta_nnz:
                raise PlanBuildError(
                    f"{what} on a dynamic matrix with {p.delta_nnz} pending "
                    "structural delta(s): call .compact() first so the "
                    "prepared pattern matches the logical matrix")
            p = p.plan
        return p

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
    def dtype(self) -> torch.dtype:
        return torch.float32  # the kernels accumulate and emit fp32

    @property
    def is_dynamic(self) -> bool:
        return isinstance(self.plan, DynamicPlan)

    @property
    def is_sharded(self) -> bool:
        p = self.plan
        return isinstance(p.plan if isinstance(p, DynamicPlan) else p,
                          ShardedPlan)

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
        """Host ``(rows, cols, vals)`` triplets of the logical matrix."""
        if isinstance(self.plan, DynamicPlan):
            return self.plan.to_coo()
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

        Functional: returns a new handle (on the static plan) and leaves
        this one as it was.  The plan signature, and so the cached
        executor, is unchanged (``dynamic.update_values`` underneath).
        """
        p = self._static_plan("with_values")
        nnz = p.update_maps.nnz
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        if tuple(values.shape) != (nnz,):
            raise ValueError(
                f"with_values needs one value per nonzero: got shape "
                f"{tuple(values.shape)} for nnz={nnz}")
        return SparseMatrix(update_values(p, np.arange(nnz), values))

    def __matmul__(self, other):
        if isinstance(other, SparseMatrix):
            return spspmm(self, other)
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
    mesh: Any = None,
    dynamic: bool = False,
    config: Optional[SpmmConfig] = None,
    **config_overrides,
) -> SparseMatrix:
    """Prepare a sparse matrix from COO triplets, on ``device``, or sharded
    across ``mesh`` (a ``distributed.SpmmMesh``; ``device`` is then its
    first device).

    The impl follows the device unless given: ``"cuda"`` on a CUDA device,
    ``"torch"`` on the CPU.  Pass a full :class:`SpmmConfig` via ``config``
    or individual fields as keyword overrides, not both: for example
    ``structure_hint=("nm", 2, 4)`` or ``structure_hint="bitmap"`` for a
    pruned weight (an N:M pattern is also detected without a hint).
    ``dynamic=True`` wraps the plan in a
    :class:`~repro_torch.dynamic.DynamicPlan` for in-place mutation.
    """
    if config is not None and config_overrides:
        raise ValueError(
            "pass either config= or individual config overrides, not both")
    if mesh is not None:
        device = mesh.first
    if config is None:
        impl = config_overrides.pop(
            "impl", "cuda" if torch.device(device).type == "cuda" else "torch")
        config = SpmmConfig(impl=impl, **config_overrides)
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    if mesh is not None:
        plan: PlanLike = core_spmm.prepare_sharded(rows, cols, vals, shape,
                                                   mesh, config)
    else:
        plan = core_spmm.prepare(rows, cols, vals, shape, config,
                                 device=device)
    return SparseMatrix(DynamicPlan(plan) if dynamic else plan)


def from_plan(plan: PlanLike) -> SparseMatrix:
    """Adopt an already-prepared plan (static or dynamic) into the
    facade."""
    return SparseMatrix(plan)


def _as_matrix(a, what: str) -> SparseMatrix:
    if isinstance(a, SparseMatrix):
        return a
    if isinstance(a, (NeutronPlan, ShardedPlan, DynamicPlan)):
        return SparseMatrix(a)
    raise TypeError(f"{what} wants a SparseMatrix, got {type(a).__name__}")


def _on_device(x, a: SparseMatrix) -> torch.Tensor:
    """A numpy operand copied to A's device; a tensor as it is."""
    return torch.from_numpy(x).to(a.device) if isinstance(x, np.ndarray) else x


def spmm(a, b, *, deadline: Optional[float] = None) -> torch.Tensor:
    """Dense ``C = A @ B`` in fp32.  ``b`` is (K, N) on A's device (a
    numpy array is copied there); batched operands go through
    :func:`bspmm`.  Differentiable in ``b``: its gradient is ``Aᵀ @ g``,
    run on the transpose plan (with the transposed sidecar on a dynamic
    matrix with pending deltas)."""
    a = _as_matrix(a, "spmm")
    b = _on_device(b, a)
    p = a.plan

    def run():
        t0 = time.monotonic()
        if isinstance(p, DynamicPlan):
            out = p.execute(b)
        elif isinstance(p, ShardedPlan):
            out = _exec.execute_sharded(p, b)
        else:
            out = _exec.execute(p, b)
        return _await(out, deadline, t0, "spmm")

    return _traced_call(
        "bspmm" if b.ndim == 3 else "spmm", a.plan,
        {"shape": a.shape, "n": int(b.shape[-1])}, run)


def bspmm(a, b, *, deadline: Optional[float] = None) -> torch.Tensor:
    """Batched SpMM: ``b`` is (batch, K, N) -> (batch, M, N), one call per
    engine path for the whole batch."""
    if b.ndim != 3:
        raise ValueError(
            f"bspmm wants a (batch, K, N) operand, got ndim={b.ndim} "
            "(use spmm for a single right-hand side)")
    return spmm(a, b, deadline=deadline)


def sddmm(a, x, y, *, deadline: Optional[float] = None) -> torch.Tensor:
    """Sampled dense-dense matmul: the values of ``X @ Y`` at A's pattern.

    ``x`` is (M, D) and ``y`` (D, K), or both with a leading batch axis, on
    A's device (numpy arrays are copied there).  Returns (nnz,) fp32 values
    ((batch, nnz) when batched) in the input COO order of ``a``, ready for
    ``a.with_values``.  Differentiable in ``x`` and ``y``: with ``S_g`` the
    pattern carrying the incoming gradient, ``dX = S_g @ Yᵀ`` and ``dY =
    (S_gᵀ @ X)ᵀ``, two SpMMs.
    """
    a = _as_matrix(a, "sddmm")
    plan = a._static_plan("sddmm")
    x, y = _on_device(x, a), _on_device(y, a)

    def run():
        t0 = time.monotonic()
        return _await(_exec.execute_sddmm(plan, x, y), deadline, t0,
                      "sddmm")

    return _traced_call("sddmm", plan, {"shape": a.shape}, run)


def spspmm(a, b, *, deadline: Optional[float] = None) -> SparseMatrix:
    """Sparse x sparse: ``C = A @ B`` as a new prepared SparseMatrix.

    The symbolic phase runs on the host on the two plans' COO mirrors, the
    numeric phase is one call on A's device
    (``exec.api.execute_spspmm``).  The product is prepared by
    :func:`from_coo` with A's config, on A's device, so it takes the whole
    operator family at once.  ``deadline`` covers the product's values,
    not its ``from_coo``.
    """
    a = _as_matrix(a, "spspmm")
    b = _as_matrix(b, "spspmm")
    a_plan = a._static_plan("spspmm")
    b_plan = b._static_plan("spspmm")

    def run():
        t0 = time.monotonic()
        out = _exec.execute_spspmm(a_plan, b_plan)
        _await(out[2], deadline, t0, "spspmm")
        return out

    cr, cc, cv, cshape = _traced_call("spspmm", a_plan, {"shape": a.shape},
                                      run)
    # the product has no window assignment yet: a product of sharded
    # inputs is prepared on one device (A's first), as in the reference;
    # from_coo(mesh=...) shards it again
    cfg = (b_plan.config if isinstance(a_plan, ShardedPlan)
           else a_plan.config)
    return from_coo(cr, cc, cv.cpu().numpy(), cshape, device=a.device,
                    config=cfg)
