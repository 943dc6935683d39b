"""Execution entry points over the executor pipeline.

``execute(plan, b)`` resolves the plan's executor from the bounded cache
and calls it on the plan's leaves: one call runs both engine paths and the
merge.  ``execute_with_delta(plan, delta, b)`` adds a dynamic plan's
structural sidecar (``plan_ir.DeltaFringe``) to the same call, and
``execute_delta_contribution`` runs the sidecar's part alone.
``execute_sddmm(plan, x, y)`` does the same for SDDMM over the
plan's pattern, and ``execute_spspmm(a_plan, b_plan)`` multiplies two
prepared patterns (a host symbolic phase, then one numeric dispatch).
``execute_sharded(splan, b, delta=None)`` runs a ``ShardedPlan`` across
its mesh in one dispatch (the per-shard body once per shard), and
``execute_sddmm``/``execute_spspmm`` take sharded plans too.

Health gate (:func:`_guarded_call`, ``exec.health``): every dispatch of a
``"cuda"`` signature asks ``HEALTH`` first.  There is no degrade tier in
this port: a ``"cuda"`` plan launches its kernels or raises.  A failed
build, kernel-library resolution or launch is recorded and re-raised as
:class:`~repro_torch.errors.KernelLoweringError`; while the signature
waits out its call-count backoff, or once it is demoted, a dispatch builds
and launches nothing and raises the same error.  ``"torch"`` signatures
(the reference's ``"xla"`` path) are not gated.

Both are differentiable in their dense operands on either impl, through
the port of the reference's ``SpMMOperator`` (a ``jax.custom_vjp``): each
is a :class:`torch.autograd.Function` whose backward runs the same
executor, on the transpose plan (:func:`transpose_plan`) for SpMM, and as
two SpMMs over the pattern for SDDMM.  The kernels' outputs carry no graph
of their own, and on ``"torch"`` the plain versions run under the
Function too, so the CPU tests cover the backward the card runs.  No
gradient flows to A's values, as in the reference.

Per-path execution and adaptive coordination (paper §5.3):
:func:`execute_matrix_path` and :func:`execute_vector_path` run one engine
path each, through the same ``ops`` calls as the fused body, and
:class:`NeutronSpMM` is the reference's epoch loop over them, which times
the two paths and moves the split threshold alpha toward balanced finish
time (Eq. 7), re-preparing the plan.  On the card each path's time is the
wall time of a synchronised call, with its CUDA-event device time beside
it.  Every host clock read in this module goes through :func:`_clock`.

Telemetry (``SpmmConfig.telemetry``): each dispatch of a telemetry-enabled
plan is timed once, synchronised before and after, and recorded in
``obs.PROFILER`` with its modeled per-path work against the H100's
ceilings (:func:`_maybe_profiled`).  With telemetry off nothing is timed
and nothing synchronises.

Spans (``obs.TRACES``): each SpMM dispatch (:func:`_execute`) is an
``execute`` span and each SDDMM on a single-device plan
(:func:`_execute_sddmm`) an ``sddmm`` span, recorded when the plan's
telemetry is on or a profiler session is active, and the transpose plan's
build a ``transpose_structure`` span, always.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import spmm as core_spmm
from ..core import tuner
from ..core.arrays import sorted_unique
from ..core.coordinator import AdaptiveCoordinator
from ..core.cost_model import (
    H100_FP32_FLOPS_PER_S, H100_HBM_BYTES_PER_S, default_cost_model,
    matrix_payload_bytes,
)
from ..core.plan_ir import (
    DeltaFringe, NeutronPlan, ShardedDeltaFringe, ShardedPlan, SpmmConfig,
    UpdateMaps, build_delta_fringe, build_sddmm_maps, delta_on,
    fringe_row_order, gather_rows, general_format_sig, permute_pad_b,
    plan_leaves, sddmm_body_leaves, sig_impl, tag_op, validate_rhs,
)
from ..core.values import set_values
from ..errors import DispatchError, KernelLoweringError, PlanBuildError
from ..kernels import _build, ops
from ..obs import PROFILER, TRACES
from . import cache as _cache
from .cache import (  # noqa: F401  (re-exported test hooks)
    dispatch_count, fused_trace_count, set_executor_cache_capacity,
    sharded_trace_count,
)
from .health import HEALTH
from .pipeline import build_delta_only_executor, build_executor

# roofline ceilings the telemetry profiler prices modeled work against: the
# H100 SXM's (NVIDIA data sheet, 700 W), not the TPU constants the split
# still runs on.  obs never imports the cost model, so they ride on every
# record.
_PEAKS = {"flops_per_s": H100_FP32_FLOPS_PER_S,
          "bytes_per_s": H100_HBM_BYTES_PER_S}


def _clock() -> float:
    """The host clock every timing in this module reads: one seam, so that
    a test can inject path times."""
    return time.perf_counter()


def _apply_cache_capacity(config: SpmmConfig) -> None:
    if config.executor_cache_capacity is not None:
        _cache.EXECUTOR_CACHE.set_capacity(config.executor_cache_capacity)


def _check_device(plan: NeutronPlan, *operands: torch.Tensor) -> None:
    for x in operands:
        if x.device != plan.device:
            raise DispatchError(
                f"operand is on {x.device} but the plan's leaves are on "
                f"{plan.device}; move it there first")


def _sig_key(sig) -> str:
    """Short deterministic key for a plan signature (telemetry label)."""
    return f"{zlib.crc32(repr(sig).encode()):08x}"


def _maybe_profiled(fn, *, kind: str, plan: NeutronPlan, sig, prof):
    """Call ``fn()`` (which builds or fetches its executor, then runs
    it), measuring it when telemetry asked for it.

    ``prof is None`` (telemetry off) is the production path: ``fn()`` as
    it is, with no clock read and no synchronisation.  With telemetry on
    the card is synchronised before and after the one call (so the time
    covers its work, not earlier queued work or the enqueue), and one
    :class:`repro_torch.obs.DispatchRecord` joins the measurement with the
    caller's modeled per-path FLOP and byte terms.  The same single call
    either way; signatures and cache keys never see the flag.  A call that
    built an executor or a kernel library is marked ``traced``.
    """
    if prof is None:
        return fn()
    marks0 = (_cache.fused_trace_count(), _build.resolved_count())
    tuner.synchronize(plan.device)
    t0 = _clock()
    out = tuner.synchronize(fn())
    measured_us = (_clock() - t0) * 1e6
    traced = (_cache.fused_trace_count(), _build.resolved_count()) != marks0
    PROFILER.record(
        op=prof["op"], tier=plan.config.impl, sig_key=_sig_key(sig),
        kind=kind, measured_us=measured_us, traced=traced,
        batch=prof.get("batch"), terms=prof["terms"], peaks=_PEAKS,
        attrs=prof.get("attrs"),
    )
    return out


def _guarded_call(sig, make_fn, args, kind: str, *, plan=None, prof=None,
                  kwargs=None):
    """Build + dispatch ``make_fn(sig)(*args, **kwargs)``, with the health
    gate for ``"cuda"`` signatures.

    ``make_fn(sig) -> fn`` builds (or fetches) the executor; the build and
    the call run inside the profiling wrapper (:func:`_maybe_profiled`),
    as in the reference.  A signature whose impl is not ``"cuda"`` (a
    ``"torch"`` plan, the reference's ``"xla"``; the ``("spspmm", ...)``
    numeric phase) takes the unguarded path: a fault there propagates as
    it is, and a failed build is not cached, so the next call builds again.

    A ``"cuda"`` signature is gated by ``HEALTH.should_try_accel``.  Where
    the reference degrades to XLA, the port raises
    :class:`KernelLoweringError`:

    - a failure in the build, the kernel library's resolution or the
      launch is recorded (``HEALTH.record_failure``: call-count backoff,
      then sticky demotion) and re-raised, chained from its cause;
    - inside the backoff, or once demoted, the dispatch builds and
      launches nothing; the message names the state and the last error;
    - a success inside the retry window records a recovery.

    No plain version ever runs in place of a kernel on the card.  Errors
    that surface on the device after the launches were queued (a fault in
    a kernel) are out of scope, as in the reference: such a fault poisons
    the CUDA context, and no retry could heal it.
    """
    kwargs = kwargs or {}

    def dispatch():
        fn = make_fn(sig)
        _cache.record_dispatch(kind)
        return fn(*args, **kwargs)

    if sig_impl(sig) != "cuda":
        return _maybe_profiled(dispatch, kind=kind, plan=plan, sig=sig,
                               prof=prof)
    if not HEALTH.should_try_accel(sig):
        raise KernelLoweringError(
            f"impl='cuda' {kind} dispatch refused, nothing built or "
            f"launched: the signature is {HEALTH.refusal(sig)}; last error: "
            f"{HEALTH.last_error(sig)}")
    try:
        out = _maybe_profiled(dispatch, kind=kind, plan=plan, sig=sig,
                              prof=prof)
    except Exception as err:  # noqa: BLE001 — every failure is recorded
        HEALTH.record_failure(sig, err)
        raise KernelLoweringError(
            f"impl='cuda' {kind} dispatch failed and there is no degrade "
            f"tier; the signature is now {HEALTH.state(sig)} "
            f"(exec.health.HEALTH): {type(err).__name__}: {err}") from err
    HEALTH.record_success(sig)
    return out


# --- modeled roofline terms (telemetry only) ---------------------------------
#
# Modeled FLOPs and bytes are lower bounds on each engine path's work, as
# in the reference: the matrix path as dense (bm x bk) tile products
# against streamed B blocks, the fringe path as per-nonzero gathers.


def _spmm_prof(plan: NeutronPlan, b: torch.Tensor, op: str = "spmm",
               paths: Tuple[str, ...] = ("matrix", "fringe")):
    """The profiler's terms for an SpMM dispatch of ``paths``, or None when
    the plan's telemetry is off."""
    config = plan.config
    if not config.telemetry:
        return None
    stats = plan.stats_dict
    n = int(b.shape[-1])
    batch = int(b.shape[0]) if b.ndim == 3 else None
    scale = float(batch or 1)
    fringe_nnz = int(stats.get("fringe_nnz", 0))
    num_steps = int(stats.get("num_steps", 0))
    num_windows = int(stats.get("num_windows", 0))
    # the matrix path alone streams the general tiles (execute_matrix_path)
    mfmt = ("general" if paths == ("matrix",)
            else str(stats.get("matrix_format", "general")))
    fparams = tuple(stats.get("format_params", (0, 0)))
    if num_steps:
        mat_flops = 2.0 * num_steps * config.bm * config.bk * n
        # the A payload models at the format the dispatch streams: packed
        # bytes for nm/bitmap, the padded dense tiles for general
        a_bytes = matrix_payload_bytes(
            mfmt, num_steps, config.bm, config.bk,
            nm_pattern=fparams if mfmt == "nm" else None,
            row_cap=int(fparams[1]) if mfmt == "bitmap" else 0,
        )
        mat_bytes = (a_bytes
                     + (num_steps * config.bk * n
                        + num_windows * config.bm * n) * 4.0)
    else:
        core_nnz = max(int(stats.get("nnz", 0)) - fringe_nnz, 0)
        mat_flops = 2.0 * core_nnz * n
        mat_bytes = core_nnz * (12.0 + 4.0 * n)
    terms = {
        "matrix": {"flops": mat_flops * scale, "bytes": mat_bytes * scale},
        "fringe": {"flops": 2.0 * fringe_nnz * n * scale,
                   "bytes": fringe_nnz * (12.0 + 4.0 * n) * scale},
    }
    return {
        "op": op, "batch": batch,
        "terms": {p: terms[p] for p in paths},
        "attrs": {
            "padding_waste": float(stats.get("padding_waste", 0.0)),
            "matrix_format": mfmt,
        },
    }


def _sddmm_prof(config: SpmmConfig, nnz: int, nnz_f: int, d: int, batch):
    if not config.telemetry:
        return None
    scale = float(batch or 1)
    core = max(int(nnz) - int(nnz_f), 0)
    return {
        "op": "sddmm", "batch": batch,
        "terms": {
            "matrix": {"flops": 2.0 * core * d * scale,
                       "bytes": core * (8.0 * d + 4.0) * scale},
            "fringe": {"flops": 2.0 * int(nnz_f) * d * scale,
                       "bytes": int(nnz_f) * (8.0 * d + 12.0) * scale},
        },
    }


def _spspmm_prof(config: SpmmConfig, n_exp: int, nnz_c: int):
    if not config.telemetry:
        return None
    # expansion products + segment sum: pure vector-engine work
    return {
        "op": "spspmm", "batch": None,
        "terms": {
            "fringe": {"flops": 2.0 * int(n_exp),
                       "bytes": 12.0 * int(n_exp) + 4.0 * int(nnz_c)},
        },
    }


def _execute(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    """:func:`execute` without the autograd Function around it.

    Recorded as an ``execute`` span when the plan's telemetry is on or a
    profiler session is active; the executor's stages are its children
    (``exec.pipeline``)."""
    with TRACES.call("execute", plan.config.telemetry, plan.device):
        validate_rhs(b, plan.shape)
        _check_device(plan, b)
        _apply_cache_capacity(plan.config)
        batch = int(b.shape[0]) if b.ndim == 3 else None
        return _guarded_call(
            plan.signature(), lambda s: build_executor(s, batch=batch),
            (*plan_leaves(plan), b), "fused" if batch is None else "batched",
            plan=plan, prof=_spmm_prof(plan, b),
            kwargs=dict(derived=plan.derived, a_flag=plan.a_unsplittable))


def _execute_with_delta(plan: NeutronPlan, delta: DeltaFringe,
                        b: torch.Tensor) -> torch.Tensor:
    """:func:`execute_with_delta` without the autograd Function around
    it."""
    validate_rhs(b, plan.shape)
    _check_device(plan, b, *delta.leaves[:1])
    _apply_cache_capacity(plan.config)
    batch = int(b.shape[0]) if b.ndim == 3 else None
    # dynamic dispatch rides the general payload, as in the reference: the
    # structured lane serves static plans, and value churn (the reason a
    # sidecar exists) would stale a packed payload
    sig = general_format_sig(plan.signature())
    return _guarded_call(
        sig, lambda s: build_executor(s, batch=batch, delta_sig=delta.sig),
        (*plan_leaves(plan), *delta.leaves, b), "fused+delta", plan=plan,
        prof=_spmm_prof(plan, b),
        kwargs=dict(derived=plan.derived, a_flag=plan.a_unsplittable,
                    delta_derived=delta.derived))


def execute_sharded(splan: ShardedPlan, b: torch.Tensor,
                    delta=None) -> torch.Tensor:
    """Multi-device coordinated SpMM: C = A @ B across ``splan.mesh``.

    ``b`` is (K, N) or (batch, K, N) on the mesh's first device, which
    also receives the result; each shard's copy of B is made with
    ``.to(device)`` (none where the device is the first's).  Every output
    row is computed by exactly one shard.

    ``delta`` adds a structural sidecar inside each shard's body: a
    ``plan_ir.ShardedDeltaFringe`` on the rows axis (each shard merges
    the rows it owns, in its local coordinates) or a plain
    ``DeltaFringe`` on the rhs axis (replicated, over the column blocks).
    One call is one dispatch of the sharded executor (kind ``"sharded"``
    or ``"sharded+delta"``), through the health gate of the per-shard
    signature: a shard whose kernel fails raises, and the gate records it.
    """
    validate_rhs(b, splan.shape)
    if b.device != splan.device:
        raise DispatchError(
            f"operand is on {b.device} but the sharded plan takes B on its "
            f"mesh's first device, {splan.device}; move it there first")
    _apply_cache_capacity(splan.config)
    batch = int(b.shape[0]) if b.ndim == 3 else None
    if splan.shard_axis == "rhs" and b.shape[-1] % splan.n_shards:
        raise DispatchError(
            f"rhs-sharded plan needs N divisible by n_shards="
            f"{splan.n_shards}; got N={b.shape[-1]} (re-prepare with "
            "shard_axis='rows' or pad B)")
    deltas = None
    if delta is not None:
        routed = isinstance(delta, ShardedDeltaFringe)
        if splan.shard_axis == "rows" and not routed:
            raise DispatchError(
                "a rows-sharded plan needs its delta routed to owning "
                "shards (plan_ir.build_sharded_delta_fringe), got a plain "
                "DeltaFringe")
        if splan.shard_axis == "rhs" and routed:
            raise DispatchError(
                "an rhs-sharded plan replicates its delta; pass the plain "
                "DeltaFringe, not a ShardedDeltaFringe")
        deltas = (delta.shards if routed else
                  tuple(delta_on(delta, sh.device) for sh in splan.shards))
    return _guarded_call(
        splan.sig,
        lambda s: build_executor(
            s, batch=batch, delta_sig=None if delta is None else delta.sig,
            shard_axis=splan.shard_axis),
        (splan.shards, splan.assemble, deltas, b),
        "sharded" if delta is None else "sharded+delta", plan=splan,
        prof=_spmm_prof(splan, b))


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


def _execute_sddmm_sharded(splan: ShardedPlan, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """SDDMM over a sharded plan's pattern: the reference's flat gather
    form over the global COO mirror, one call on the mesh's first device
    (B5's row walk on the card).  The walk is built once per structure and
    kept on the maps."""
    maps = splan.update_maps
    if maps is None:
        raise PlanBuildError(
            "sddmm on a sharded plan needs its global COO mirror "
            "(ShardedUpdateMaps); this plan has none: re-prepare from COO")
    batch = validate_sddmm_operands(x, y, splan.shape)
    _check_device(splan, x, y)
    _apply_cache_capacity(splan.config)
    dev = splan.device
    if maps.nnz == 0:
        shape = (0,) if batch is None else (batch, 0)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    walk = getattr(maps, "_sddmm_walk", None)
    if walk is None or walk.indptr.device != dev:
        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

        walk = fringe_row_order(on_dev(maps.rows), on_dev(maps.cols),
                                on_dev(np.arange(maps.nnz)), splan.shape[0])
        maps._sddmm_walk = walk
    cfg = splan.config
    return _guarded_call(
        ("sddmm_flat", cfg.impl, maps.nnz, cfg.fringe_chunk),
        lambda s: build_executor(s, batch=batch), (*walk, x, y), "sddmm",
        plan=splan,
        # flat gather form: every nonzero rides the vector path
        prof=_sddmm_prof(cfg, maps.nnz, maps.nnz, int(x.shape[-1]), batch))


def _execute_sddmm(plan: NeutronPlan, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """:func:`execute_sddmm` without the autograd Function around it.

    Recorded as an ``sddmm`` span when the plan's telemetry is on or a
    profiler session is active; the body's stages are its children
    (``exec.pipeline._sddmm_body``), once per item of a batch."""
    with TRACES.call("sddmm", plan.config.telemetry, plan.device):
        smaps = build_sddmm_maps(plan)
        batch = validate_sddmm_operands(x, y, plan.shape)
        _check_device(plan, x, y)
        _apply_cache_capacity(plan.config)
        if smaps.nnz == 0:
            shape = (0,) if batch is None else (batch, 0)
            return torch.zeros(shape, dtype=torch.float32,
                               device=plan.device)
        if getattr(plan.config, "autotune", False) and (
                plan.config.impl == "cuda"):
            # the tuned SDDMM tier, as the reference resolves it for its
            # kernel impls; under the H100 rule a "cuda" plan's tier is
            # always the gather kernel (a stored "xla" is ignored and
            # counted by the tuner), so the op tag keeps the config's
            # budget.  A "torch" plan never reads the tier, as the
            # reference's "xla" does not.
            tuner.resolve_cost_model(
                "sddmm", int(plan.shape[0]), int(plan.shape[1]), smaps.nnz,
                plan.config,
            ).select_sddmm_tier(
                int(x.shape[-1]), int(plan.shape[0]), int(plan.shape[1]),
                vmem_budget=plan.config.fringe_vmem_budget, impl="cuda")
        sig = tag_op(plan.signature(), "sddmm", smaps.nnz, smaps.nnz_f,
                     plan.config.fringe_vmem_budget)
        return _guarded_call(
            sig, lambda s: build_executor(s, batch=batch),
            (*sddmm_body_leaves(plan, smaps), x, y), "sddmm", plan=plan,
            prof=_sddmm_prof(plan.config, smaps.nnz, smaps.nnz_f,
                             int(x.shape[-1]), batch),
            kwargs=dict(derived=plan.derived))


# --- sparse x sparse (spspmm) ----------------------------------------------


def spspmm_symbolic(ma: UpdateMaps, mb: UpdateMaps, n: int, bm_b: int):
    """The host symbolic phase of ``C = A @ B`` on the two plans' COO
    mirrors (``n`` is B's column count, ``bm_b`` B's row-window height),
    as the reference computes it: A nonzeros whose column falls in an
    empty row window of B are dropped, the survivors expand to
    (A-nonzero, B-nonzero) term pairs by binary search over B's row-sorted
    order, and the terms are stably sorted by their output cell.

    Returns ``(ae, be, lengths, c_keys)``: term ``t`` multiplies A's
    nonzero ``ae[t]`` by B's ``be[t]``; output slot ``s`` is cell
    ``c_keys[s]`` (``row * n + col``, ascending) and sums the next
    ``lengths[s]`` terms.  None when the product has no term.
    """
    ar, ac = ma.rows, ma.cols
    br, bc = mb.rows, mb.cols
    if ar.size == 0 or br.size == 0:
        return None
    # coarse row-window intersection: a B row window with no nonzeros can
    # satisfy no A column that lands in it
    n_win = (mb.shape[0] + bm_b - 1) // bm_b
    active_win = np.zeros(n_win, bool)
    active_win[sorted_unique(br // bm_b)] = True
    keep = np.flatnonzero(active_win[ac // bm_b])
    if keep.size == 0:
        return None
    ob = np.argsort(br, kind="stable")
    brs = br[ob]
    starts = np.searchsorted(brs, ac[keep])
    deg = np.searchsorted(brs, ac[keep], side="right") - starts
    n_exp = int(deg.sum())
    if n_exp == 0:
        return None
    ae = np.repeat(keep, deg)
    cum = np.cumsum(deg) - deg
    be = ob[np.arange(n_exp) - np.repeat(cum, deg) + np.repeat(starts, deg)]
    key = ar[ae] * np.int64(n) + bc[be]
    order = np.argsort(key, kind="stable")
    ae, be, key = ae[order], be[order], key[order]
    first = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    lengths = np.diff(np.append(first, n_exp))
    return ae, be, lengths, key[first]


def execute_spspmm(a_plan: NeutronPlan, b_plan: NeutronPlan):
    """Sparse x sparse matmul: ``C = A @ B`` from two prepared patterns.

    Two phases, as in the reference.  The symbolic phase runs on the host
    on the plans' COO mirrors (:func:`spspmm_symbolic`).  The numeric phase
    is one call on A's plan device, through the executor cache and the
    dispatch counter: the products ``va[ae] * vb[be]`` in fp32, summed per
    output slot in term order (``pipeline._spspmm_body``).  Duplicate COO
    triplets in either input expand independently, so they accumulate as
    in the dense product.

    Returns ``(rows, cols, vals, shape)``: a COO triple in row-major order
    with unique cells, ``vals`` fp32 on A's device, ready for
    ``sparse.from_coo``.  Raises :class:`PlanBuildError` when either plan
    has no ``update_maps``, ``ValueError`` when the inner dimensions
    disagree and :class:`DispatchError` when the plans are on different
    devices.
    """
    ma, mb = a_plan.update_maps, b_plan.update_maps
    if ma is None or mb is None:
        raise PlanBuildError(
            "spspmm needs both plans' COO mirrors (update_maps); prepare "
            "from COO, or carry them with interop.update_maps_from_arrays")
    m, ka = a_plan.shape
    kb, n = b_plan.shape
    if ka != kb:
        raise ValueError(
            f"spspmm inner dimensions disagree: A is {a_plan.shape}, "
            f"B is {b_plan.shape}")
    dev = a_plan.device
    if b_plan.device != dev:
        raise DispatchError(
            f"spspmm operands live on different devices: A on {dev}, B on "
            f"{b_plan.device}")
    _apply_cache_capacity(a_plan.config)
    terms = spspmm_symbolic(ma, mb, n, b_plan.config.bm)
    if terms is None:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                torch.zeros(0, dtype=torch.float32, device=dev), (m, n))
    ae, be, lengths, c_keys = terms
    n_exp, nnz_c = int(ae.size), int(c_keys.size)
    args = (
        torch.from_numpy(ae.astype(np.int32)).to(dev),
        torch.from_numpy(be.astype(np.int32)).to(dev),
        torch.from_numpy(lengths).to(dev),
        torch.as_tensor(ma.vals, dtype=torch.float32).to(dev),
        torch.as_tensor(mb.vals, dtype=torch.float32).to(dev),
    )
    vals = _guarded_call(
        ("spspmm", n_exp, nnz_c), build_executor, args, "spspmm",
        plan=a_plan, prof=_spspmm_prof(a_plan.config, n_exp, nnz_c))
    return c_keys // n, c_keys % n, vals, (m, n)


# --- the backward: transpose plans and the autograd Functions --------------


def transpose_structure(plan: NeutronPlan) -> NeutronPlan:
    """The plan of Aᵀ: ``prepare`` of ``(cols, rows, vals)`` with shape
    ``(K, M)``, the same config and the same device, as the reference's
    ``SpMMOperator.plan_t``.  Its COO is in A's input order, so nonzero
    ``i`` of A is nonzero ``i`` of Aᵀ.

    Built once per structure and cached in ``plan.derived``, which every
    plan that ``update_values`` derives from this one shares: so only the
    structure may be relied on.  Its values are those of the plan that
    first asked; :func:`transpose_plan` gives a plan's own.  The build is
    an ``obs`` span, ``transpose_structure``, with its ``prepare`` inside.
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
        with TRACES.build("transpose_structure"):
            cached = core_spmm.prepare(maps.cols, maps.rows,
                                       maps.host_values(), (k, m),
                                       plan.config, device=plan.device)
        plan.derived["transpose_structure"] = cached
        # whose values the structure holds: that plan's values, by identity
        # (a value update gives every updated plan a new object)
        plan.derived["transpose_values_of"] = weakref.ref(maps.vals)
    return cached


def transpose_plan(plan: NeutronPlan) -> NeutronPlan:
    """The plan of Aᵀ with ``plan``'s values.  For the plan whose values
    the cached structure (:func:`transpose_structure`) holds, that
    structure; for another, the structure with its values written in
    (``core.values.set_values``), kept for the last such plan in
    ``plan.derived`` so that its next backward builds nothing.  Plans are
    told apart by the identity of their values (``UpdateMaps.vals``), so
    no call compares values."""
    structure = transpose_structure(plan)
    derived = plan.derived
    vals = plan.update_maps.vals
    if derived["transpose_values_of"]() is vals:
        return structure
    last = derived.get("transpose_last")
    if last is not None and last[0]() is vals:
        return last[1]
    own = set_values(structure, vals)
    derived["transpose_last"] = (weakref.ref(vals), own)
    return own


def transpose_delta(plan: NeutronPlan, delta: DeltaFringe) -> DeltaFringe:
    """The sidecar of Aᵀ: ``delta``'s entries with rows and columns
    swapped, built by ``build_delta_fringe`` at shape ``(K, M)`` with the
    same capacity, on the plan's device.  Built once per sidecar and kept
    in its ``derived`` (a sidecar's entries never change: a new overlay
    builds a new sidecar)."""
    cached = delta.derived.get("transpose")
    if cached is None:
        rows, cols, vals = delta.coo
        m, k = plan.shape
        cached = build_delta_fringe(cols, rows, vals, (k, m), plan.config,
                                    capacity=delta.capacity,
                                    device=plan.device)
        delta.derived["transpose"] = cached
    return cached


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


class SpMMDeltaFunction(torch.autograd.Function):
    """``C = (A + Δ) @ B`` with ``dL/dB = (A + Δ)ᵀ @ dL/dC``: the backward
    is one ``fused+delta`` dispatch of the transpose plan with the
    transposed sidecar (:func:`transpose_delta`)."""

    @staticmethod
    def forward(ctx, b: torch.Tensor, plan: NeutronPlan,
                delta: DeltaFringe) -> torch.Tensor:
        ctx.plan, ctx.delta = plan, delta
        ctx.b_dtype = b.dtype
        return _execute_with_delta(plan, delta, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        db = _execute_with_delta(transpose_plan(ctx.plan),
                                 transpose_delta(ctx.plan, ctx.delta),
                                 g.contiguous())
        return db.to(ctx.b_dtype), None, None


def _sddmm_grads(plan: NeutronPlan, x: torch.Tensor, y: torch.Tensor,
                 g: torch.Tensor, need_x: bool, need_y: bool):
    """dX = S_g @ Yᵀ and dY = (S_gᵀ @ X)ᵀ for one (M, D) x, (D, K) y and
    (nnz,) g, where S_g is the pattern carrying g (duplicate entries sum
    in their shared slot, as a value update writes them)."""
    dx = dy = None
    if need_x:
        dx = _execute(set_values(plan, g), y.t().to(torch.float32))
    if need_y:
        at = set_values(transpose_structure(plan), g)
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


def execute_with_delta(plan: NeutronPlan, delta: DeltaFringe,
                       b: torch.Tensor) -> torch.Tensor:
    """C = (A_base + A_delta) @ B in one call.

    ``delta`` is a ``plan_ir.DeltaFringe`` on the plan's device.  The
    sidecar's contribution joins the merge of the base plan's two engine
    paths in the same executor (kind ``"fused+delta"``), on the general
    payload's signature (``plan_ir.general_format_sig``), which the health
    gate keys: a failed sidecar launch counts against it and raises
    ``KernelLoweringError``, as every ``"cuda"`` dispatch does.
    Differentiable in ``b`` (:class:`SpMMDeltaFunction`).
    """
    return SpMMDeltaFunction.apply(b, plan, delta)


def execute_delta_contribution(shape: Tuple[int, int], config: SpmmConfig,
                               delta: DeltaFringe,
                               b: torch.Tensor) -> torch.Tensor:
    """The sidecar's own (M, N) (or (batch, M, N)) contribution, one call
    of its own executor: the differential baseline of the fused merge, and
    the sidecar term alone for callers that want it.  Not gated and not
    differentiable, as in the reference."""
    validate_rhs(b, shape)
    batch = int(b.shape[0]) if b.ndim == 3 else None
    fn = build_delta_only_executor(shape[0], config.bk, config.impl,
                                   config.fringe_chunk, delta.sig, batch)
    _cache.record_dispatch("delta_only")
    col_perm = torch.arange(shape[1], dtype=torch.int32, device=b.device)
    return fn(*delta.leaves, col_perm, b, derived=delta.derived)


def execute_sddmm(plan: NeutronPlan, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul over a plan's sparsity pattern.

    Computes ``(X @ Y)[i, j]`` at exactly the pattern's nonzeros and returns
    them as fp32 ``(nnz,)`` (batched operands give ``(batch, nnz)``) in the
    plan's input COO order, the order ``SparseMatrix.with_values`` takes.
    One call runs the dense-tile kernel on the plan's tiles and the gather
    kernel on its fringe.  Differentiable in ``x`` and ``y``
    (:class:`SDDMMFunction`).  On a :class:`ShardedPlan` it is the
    reference's flat gather over the global COO, on the mesh's first
    device (:func:`_execute_sddmm_sharded`), with no backward.
    """
    if isinstance(plan, ShardedPlan):
        return _execute_sddmm_sharded(plan, x, y)
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


# --- per-path execution and adaptive coordination (paper §5.3) --------------


def _pad_b(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    cfg = plan.config
    return permute_pad_b(b, plan.col_perm, cfg.reorder_cols, cfg.bk)


def _check_path_operand(plan: NeutronPlan, b: torch.Tensor) -> None:
    validate_rhs(b, plan.shape)
    if b.ndim != 2:
        raise ValueError(
            f"the per-path executors take one (K, N) operand, got shape "
            f"{tuple(b.shape)}")
    _check_device(plan, b)


def execute_matrix_path(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    """Dense-core path only; returns its (M, N) contribution, fp32.

    As in the reference, the matrix path runs ``block_stream_spmm`` (B1)
    on the plan's general tile stream whatever the plan's
    ``matrix_format``: an N:M or bitmap plan's structured payload is the
    fused executor's.  With no core it returns zeros and launches nothing.
    """
    _check_path_operand(plan, b)
    m, n = plan.shape[0], b.shape[1]
    if not plan.has_core:   # no dispatch at all
        return torch.zeros((m, n), dtype=torch.float32, device=plan.device)
    cfg = plan.config

    def run():
        packed = ops.block_stream_spmm(
            plan.step_window, plan.step_col, plan.flat_values,
            _pad_b(plan, b), num_windows=plan.num_windows, bm=cfg.bm,
            bk=cfg.bk, impl=cfg.impl, derived=plan.derived,
            a_flag=plan.a_unsplittable,
        )
        return gather_rows(packed, plan.gather_src_matrix)

    return _maybe_profiled(
        run, kind="matrix_path", plan=plan, sig=plan.signature(),
        prof=_spmm_prof(plan, b, op="spmm:matrix_path", paths=("matrix",)))


def execute_vector_path(plan: NeutronPlan, b: torch.Tensor) -> torch.Tensor:
    """Fringe path only; returns its (M, N) contribution, fp32, on the
    plan's fringe tier.  With no fringe it returns zeros and launches
    nothing.  ``execute_matrix_path(plan, b) + execute_vector_path(plan,
    b)`` is the fused ``execute`` of a general plan, bit for bit: the
    fused body adds the same two tensors in the same order."""
    _check_path_operand(plan, b)
    m, n = plan.shape[0], b.shape[1]
    if not plan.has_fringe:   # no dispatch at all
        return torch.zeros((m, n), dtype=torch.float32, device=plan.device)
    cfg = plan.config

    def run():
        packed = ops.fringe_spmm(
            plan.fringe_rows, plan.fringe_cols, plan.fringe_vals,
            _pad_b(plan, b), num_rows=int(plan.fringe_row_ids.shape[0]),
            impl=cfg.impl, chunk=cfg.fringe_chunk, tier=plan.fringe_tier,
            bk=plan.fringe_bk, kb_chunk=plan.fringe_kb_chunk,
            kb_rows=plan.fringe_kb_rows, kb_cols=plan.fringe_kb_cols,
            kb_vals=plan.fringe_kb_vals, derived=plan.derived,
        )
        return gather_rows(packed, plan.gather_src_vector)

    return _maybe_profiled(
        run, kind="vector_path", plan=plan, sig=plan.signature(),
        prof=_spmm_prof(plan, b, op="spmm:vector_path", paths=("fringe",)))


def neutron_spmm(rows, cols, vals, shape: Tuple[int, int],
                 b: torch.Tensor, config: SpmmConfig = SpmmConfig(), *,
                 device=None) -> torch.Tensor:
    """One-shot convenience: prepare (on ``device``, by default the one
    ``config.impl`` runs on) + execute."""
    plan = core_spmm.prepare(np.asarray(rows), np.asarray(cols),
                             np.asarray(vals), shape, config, device=device)
    return execute(plan, b)


def _timed_path(path, plan: NeutronPlan, b: torch.Tensor):
    """``(out, wall seconds, device seconds)`` of one synchronised call of
    ``path(plan, b)``: synchronise, read the clock, run, synchronise, read
    the clock (host launch time included, as the reference's
    ``block_until_ready`` discipline).  On the card, CUDA events around the
    call give its device time; on the CPU that is None."""
    dev = plan.device
    events = None
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    tuner.synchronize(dev)
    t0 = _clock()
    if events:
        events[0].record(stream)
    out = path(plan, b)
    if events:
        events[1].record(stream)
    tuner.synchronize(dev)
    wall = _clock() - t0
    device_s = (events[0].elapsed_time(events[1]) / 1e3 if events
                else None)
    return out, wall, device_s


class NeutronSpMM:
    """Epoch-loop operator with adaptive AIV-AIC coordination (§5.3).

    Re-prepares the plan, on the plan's device, when the coordinator
    moves alpha.  Each epoch times the two paths with :func:`_timed_path`
    (synchronised wall time, the reference's measure, which drives the
    rebalance) and logs each path's CUDA-event device time beside it
    (``t_matrix_device``, ``t_vector_device``; None on the CPU).  The
    first call after each (re-)prepare is a warm-up and is not timed.
    ``prepare_seconds`` holds the host seconds of every prepare.
    """

    def __init__(self, rows, cols, vals, shape: Tuple[int, int],
                 config: SpmmConfig = SpmmConfig(), cost_model=None,
                 epsilon: float = 0.05, *, device=None):
        self.rows, self.cols, self.vals = (
            np.asarray(rows), np.asarray(cols), np.asarray(vals))
        self.shape = tuple(shape)
        self.config = config
        self.cost_model = cost_model or default_cost_model(n_cols=config.bn)
        self.prepare_seconds: list = []
        self.plan = self._prepare(config, device)
        self.epsilon = epsilon
        self._alpha = self.plan.stats_dict["alpha"]
        self._needs_warmup = True
        self.epoch_log: list = []

    def _prepare(self, config: SpmmConfig, device) -> NeutronPlan:
        t0 = _clock()
        plan = core_spmm.prepare(self.rows, self.cols, self.vals, self.shape,
                                 config, self.cost_model, device=device)
        self.prepare_seconds.append(_clock() - t0)
        return plan

    def run_epoch(self, b: torch.Tensor) -> torch.Tensor:
        if self._needs_warmup:   # builds and first launches stay untimed
            tuner.synchronize(execute_matrix_path(self.plan, b))
            tuner.synchronize(execute_vector_path(self.plan, b))
            self._needs_warmup = False
        cm, t_matrix, d_matrix = _timed_path(execute_matrix_path, self.plan,
                                             b)
        cv, t_vector, d_vector = _timed_path(execute_vector_path, self.plan,
                                             b)
        skew = AdaptiveCoordinator.skew(t_matrix, t_vector)
        self.epoch_log.append({
            "t_matrix": t_matrix, "t_vector": t_vector, "skew": skew,
            "alpha": self._alpha,
            "t_matrix_device": d_matrix, "t_vector_device": d_vector,
        })
        if skew > 1.0 + self.epsilon and len(self.epoch_log) >= 2:
            self._rebalance(t_matrix, t_vector)
        return cm + cv

    def _rebalance(self, t_matrix: float, t_vector: float) -> None:
        """Nudge alpha toward balanced finish time and re-prepare (Eq. 7)."""
        ratio = t_matrix / max(t_vector, 1e-12)
        # matrix slower -> raise alpha (send more to the vector path)
        new_alpha = float(np.clip(self._alpha * ratio ** 0.5, 1e-6, 1.0))
        if abs(new_alpha - self._alpha) / max(self._alpha, 1e-12) < 1e-3:
            return
        self._alpha = new_alpha
        cfg = dataclasses.replace(self.config, alpha=new_alpha)
        self.plan = self._prepare(cfg, self.plan.device)
        self._needs_warmup = True
