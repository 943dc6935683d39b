"""Executor pipeline: the fused body for a plan signature.

The fused body runs both engine paths and merges them without a scatter:

    matrix path (block_stream_spmm) -> gather_rows(packed, gather_src_matrix)
    vector path (fringe_spmm)       -> gather_rows(packed, gather_src_vector)
    C = sum of the two

A batched (batch, K, N) operand is folded into columns, (K, batch*N), so
each path launches once for the whole batch and the output is unfolded to
(batch, M, N): the port's replacement for the reference's ``vmap``.  The
signature's matrix format picks the matrix-path payload: the N:M or bitmap
encoding on a structured plan, the flat tile stream otherwise.

A delta signature (``delta_sig``, a ``plan_ir.DeltaFringe.sig``) adds a
dynamic plan's structural sidecar to the SpMM body: its contribution
(``ops.delta_fringe_spmm`` through the fringe tiers, then its own row
gather) is added to the merged paths in the same call, as the reference
merges it inside its one jitted program (:func:`_delta_contrib_body`).

A signature tagged with ``plan_ir.tag_op(sig, "sddmm", ...)`` selects the
SDDMM body instead, on the same plan structure: the values at the plan's
core slots (``core_lin``) on the matrix path, per-nonzero dots on the
vector path, merged in the input COO order.  A ``("spspmm", n_exp,
nnz_c)`` signature selects the numeric phase of the sparse x sparse
product (:func:`_spspmm_body`).

Each build fires the fault seams of ``repro_torch.robust``:
``executor_build`` for every signature, then ``pallas_lowering`` for a
``"cuda"`` one, where the reference lowers its Pallas tiers.  A cache hit
builds nothing and fires neither.

A sharded plan's per-shard signature with ``shard_axis`` builds the
sharded flavour (:func:`_sharded`): the same body launched once per shard
on its device, the port of the reference's ``shard_map`` wrap; its SDDMM
is the flat gather over the global COO (:func:`_sddmm_flat_body`).

Executors live in the bounded LRU ``exec.cache.EXECUTOR_CACHE`` keyed by
(signature, batch, delta signature, and the shard axis where there is
one); a tagged signature never equals an
untagged one, so an SDDMM executor never aliases an SpMM one.  A value
update keeps both signatures, so it builds nothing; a sidecar's signature
changes only when its capacity doubles.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.plan_ir import (
    LEAF_COL_PERM, N_DELTA_LEAVES, N_PLAN_LEAVES, delta_child_sig,
    gather_rows, op_extra, permute_pad_b, sig_impl, sig_op, untag_sig,
)
from ..errors import PlanBuildError
from ..kernels import ops
from ..robust.faults import HARNESS
from .cache import EXECUTOR_CACHE, record_build


def _fused_body(sig: Tuple):
    """Fused executor body for a plan signature.

    Returns ``run(*plan_leaves, b, derived=None, a_flag=None)`` for a
    single (K, N) operand; ``derived`` is the plan's cache of kernel-side
    index arrays and ``a_flag`` its ``a_unsplittable``.
    """
    (_version, shape, bm, bk, _bn, impl, reorder_cols, fringe_chunk,
     num_windows, _num_steps, _nnz_f, n_fringe_rows, has_core, has_fringe,
     fringe_tier, fringe_bk, _n_chunks, _nnz_kb,
     matrix_format, format_params) = sig
    m, _k = shape

    def run(step_window, step_col, flat_values, fringe_rows, fringe_cols,
            fringe_vals, col_perm, gsrc_m, gsrc_v,
            kb_chunk, kb_rows, kb_cols, kb_vals,
            nm_values, nm_codes, bitmap_words, bitmap_values, b,
            derived: Optional[Dict[str, Any]] = None,
            a_flag: Optional[torch.Tensor] = None):
        n = b.shape[1]
        bp = permute_pad_b(b, col_perm, reorder_cols, bk)
        c = None
        if has_core:
            # the signature-carried format selects the payload; the general
            # stream always rides along (a demoted plan reads it)
            if matrix_format == "nm":
                n_pat, m_pat = format_params
                packed_m = ops.nm_stream_spmm(
                    step_window, step_col, nm_values, nm_codes, bp,
                    num_windows=num_windows, bm=bm, bk=bk, n_pat=n_pat,
                    m_pat=m_pat, impl=impl, derived=derived, a_flag=a_flag,
                )
            elif matrix_format == "bitmap":
                _n_words, row_cap = format_params
                packed_m = ops.bitmap_stream_spmm(
                    step_window, step_col, bitmap_words, bitmap_values, bp,
                    num_windows=num_windows, bm=bm, bk=bk, row_cap=row_cap,
                    impl=impl, derived=derived, a_flag=a_flag,
                )
            else:
                packed_m = ops.block_stream_spmm(
                    step_window, step_col, flat_values, bp,
                    num_windows=num_windows, bm=bm, bk=bk, impl=impl,
                    derived=derived, a_flag=a_flag,
                )
            c = gather_rows(packed_m, gsrc_m)
        if has_fringe:
            packed_v = ops.fringe_spmm(
                fringe_rows, fringe_cols, fringe_vals, bp,
                num_rows=n_fringe_rows, impl=impl, chunk=fringe_chunk,
                tier=fringe_tier, bk=fringe_bk,
                kb_chunk=kb_chunk, kb_rows=kb_rows,
                kb_cols=kb_cols, kb_vals=kb_vals, derived=derived,
            )
            cv = gather_rows(packed_v, gsrc_v)
            c = cv if c is None else c + cv
        if c is None:  # empty matrix
            c = torch.zeros((m, n), dtype=torch.float32, device=b.device)
        return c

    return run


def _sddmm_body(sig: Tuple):
    """SDDMM body for an op-tagged plan signature.

    Returns ``run(step_window, step_col, core_row_map, col_perm, core_lin,
    w_indptr, w_cols, w_pos, x, y, derived=None)`` for one (M, D) x and
    (D, K) y; the output is (nnz,) fp32 in the plan's input COO order.
    Both paths read one Y^T panel, permuted and padded as SpMM permutes
    and pads B's rows: the fringe walk (``w_*``, ``SddmmMaps.walk``) writes
    each fringe dot at its position, the matrix path each core value at
    its.  Unlike the reference, whose ``"xla"`` impl skips the tile path
    and gathers every nonzero, both impls run both paths here:
    ``"torch"`` with the plain versions, so the CPU tests cover the
    placement the card runs.
    """
    (_version, _shape, bm, bk, _bn, impl, reorder_cols, fringe_chunk,
     _num_windows, _num_steps, _nnz_f, _n_fringe_rows, has_core, has_fringe,
     _fringe_tier, _fringe_bk, _n_chunks, _nnz_kb,
     _matrix_format, _format_params) = untag_sig(sig)
    nnz, _nnz_fs, vmem_budget = op_extra(sig)

    def run(step_window, step_col, core_row_map, col_perm,
            core_lin, w_indptr, w_cols, w_pos, x, y,
            derived: Optional[Dict[str, Any]] = None):
        x = x.to(torch.float32).contiguous()
        ypt = permute_pad_b(y.t(), col_perm, reorder_cols, bk)  # (K, D)
        out = torch.empty(nnz, dtype=torch.float32, device=x.device)
        if has_fringe:
            ops.sddmm_gather(w_indptr, w_cols, w_pos, x, ypt, out,
                             impl=impl, chunk=fringe_chunk,
                             vmem_budget=vmem_budget)
        if has_core:
            # matrix path: window-gathered X rows against the same panel
            xp = gather_rows(x, core_row_map).contiguous()
            ops.sddmm_block_stream(step_window, step_col, core_lin, xp, ypt,
                                   out, bm=bm, bk=bk, impl=impl,
                                   derived=derived)
        return out

    return run


def _batched_sddmm(run):
    """(batch, M, D) and (batch, D, K) operands: one SDDMM per item,
    stacked to (batch, nnz)."""

    def run_batched(*args, derived=None):
        *leaves, x, y = args
        return torch.stack([run(*leaves, xi, yi, derived=derived)
                            for xi, yi in zip(x, y)])

    return run_batched


def _batched(run):
    """Fold a (batch, K, N) operand into (K, batch*N), run once, unfold."""

    def run_batched(*args, **kwargs):
        *leaves, b = args
        batch, k, n = b.shape
        folded = b.permute(1, 0, 2).reshape(k, batch * n)
        out = run(*leaves, folded, **kwargs)
        return out.reshape(out.shape[0], batch, n).permute(1, 0, 2)

    return run_batched


def _delta_contrib_body(m: int, bk_cfg: int, impl: str, reorder_cols: bool,
                        fringe_chunk, dsig: Tuple):
    """The sidecar's contribution: ``contrib(d_rows, d_cols, d_vals,
    d_gsrc, kb_chunk, kb_rows, kb_cols, kb_vals, col_perm, b,
    derived=None) -> (m, N)``, where ``derived`` is the sidecar's own
    cache (``DeltaFringe.derived``)."""
    _tag, _cap, num_rows, tier, dbk, _nch, _nkb = delta_child_sig(dsig)

    def contrib(d_rows, d_cols, d_vals, d_gsrc, kbc, kbr, kbcol, kbv,
                col_perm, b, derived: Optional[Dict[str, Any]] = None):
        bp = permute_pad_b(b, col_perm, reorder_cols, bk_cfg)
        packed = ops.delta_fringe_spmm(
            d_rows, d_cols, d_vals, bp, num_rows=num_rows, impl=impl,
            chunk=fringe_chunk, tier=tier, bk=dbk, kb_chunk=kbc,
            kb_rows=kbr, kb_cols=kbcol, kb_vals=kbv, derived=derived)
        return gather_rows(packed, d_gsrc)

    return contrib


def _with_delta(run, sig: Tuple, dsig: Tuple):
    """The SpMM body plus the sidecar's contribution: ``(*plan_leaves,
    *delta_leaves, b, derived=None, a_flag=None, delta_derived=None)``."""
    (_version, shape, _bm, bk, _bn, impl, reorder_cols, fringe_chunk,
     *_rest) = sig
    contrib = _delta_contrib_body(shape[0], bk, impl, reorder_cols,
                                  fringe_chunk, dsig)

    def body(*args, derived=None, a_flag=None, delta_derived=None):
        leaves = args[:N_PLAN_LEAVES]
        dleaves = args[N_PLAN_LEAVES:N_PLAN_LEAVES + N_DELTA_LEAVES]
        b = args[-1]
        return (run(*leaves, b, derived=derived, a_flag=a_flag)
                + contrib(*dleaves, leaves[LEAF_COL_PERM], b,
                          derived=delta_derived))

    return body


def _spspmm_body(sig: Tuple):
    """Numeric SpGEMM body for ``("spspmm", n_exp, nnz_c)`` signatures.

    The symbolic phase (``exec.api.spspmm_symbolic``) gives three index
    streams: term ``t`` multiplies A's nonzero ``ae[t]`` by B's nonzero
    ``be[t]``, and the terms are sorted by output slot, slot ``s`` owning
    the next ``lengths[s]`` of them.  Returns ``run(ae, be, lengths, va,
    vb)``: the products in fp32, each slot's run summed left to right in
    term order, as the reference's sorted ``segment_sum``.  The sum is
    deterministic on either device: an ``(n, 1)`` operand takes
    ``torch.segment_reduce``'s loop of one thread per segment on the card
    (a 1-D one goes to a tree reduction, whose order differs), and the
    CPU's loop is sequential; no atomics.  The reference leaves this to
    XLA, outside any Pallas kernel, so no kernel of the port's runs here.
    """
    _tag, _n_exp, _nnz_c = sig

    def run(ae, be, lengths, va, vb):
        prod = (torch.index_select(va, 0, ae)
                * torch.index_select(vb, 0, be))
        return torch.segment_reduce(prod[:, None], "sum", lengths=lengths,
                                    axis=0, unsafe=True)[:, 0]

    return run


def _sddmm_flat_body(sig: Tuple):
    """Gather-only SDDMM body for ``("sddmm_flat", impl, nnz, chunk)``
    signatures: the sharded plan's form, as in the reference.  A sharded
    plan keeps one global COO mirror and the output is a flat (nnz,)
    vector, so every nonzero takes one dot, on the mesh's first device.

    Returns ``run(w_indptr, w_cols, w_pos, x, y, derived=None)``: the
    nonzeros walked in row order (``plan_ir.fringe_row_order`` of the
    global COO), each dot written at its input position; on the card that
    is B5's walk (``ops.sddmm_gather``).  ``derived`` is unused: the walk
    is the whole index state."""
    _tag, impl, nnz, chunk = sig

    def run(w_indptr, w_cols, w_pos, x, y, derived=None):
        x = x.to(torch.float32).contiguous()
        yt = y.t().to(torch.float32).contiguous()
        out = torch.empty(nnz, dtype=torch.float32, device=x.device)
        return ops.sddmm_gather(w_indptr, w_cols, w_pos, x, yt, out,
                                impl=impl, chunk=chunk)

    return run


def _sharded(run, shard_axis: str):
    """The per-shard body launched once per shard, each on its shard's
    device: the port of the reference's ``shard_map`` wrap.

    Returns ``exec_(shards, assemble, deltas, b)``: ``shards`` are the
    plan's ``PlanShard``s, ``deltas`` one sidecar per shard (None for
    none), ``b`` on the mesh's first device, which receives the result.
    Rows axis: every shard runs on all of B and emits its packed
    ``(rows_per_shard, N)`` block; the blocks are concatenated on the
    first device and ``assemble`` gathers C's rows from them (one
    ``index_select``).  Rhs axis: shard ``s`` runs the replicated plan on
    B's ``s``-th block of N / n columns, and the blocks are concatenated
    along N.  B reaches each device with ``.to``, which is no copy where
    the device is B's own."""
    rows_axis = shard_axis == "rows"

    def exec_(shards, assemble, deltas, b):
        home = b.device
        n_shards = len(shards)
        width = b.shape[-1] // n_shards
        outs = []
        for s, sh in enumerate(shards):
            bs = b if rows_axis else b[..., s * width:(s + 1) * width]
            bs = bs.to(sh.device)
            kw = dict(derived=sh.derived, a_flag=sh.a_unsplittable)
            if deltas is None:
                out = run(*sh.leaves, bs, **kw)
            else:
                out = run(*sh.leaves, *deltas[s].leaves, bs,
                          delta_derived=deltas[s].derived, **kw)
            outs.append(out.to(home))
        if rows_axis:
            return torch.index_select(torch.cat(outs, dim=-2), -2,
                                      assemble)
        return torch.cat(outs, dim=-1)

    return exec_


def _build(sig: Tuple, batch: Optional[int], dsig: Optional[Tuple],
           shard_axis: Optional[str] = None):
    # fault seams: once per executor *build* (a cache hit skips _build)
    HARNESS.fire("executor_build", context=sig)
    if sig_impl(sig) == "cuda":
        HARNESS.fire("pallas_lowering", context=sig)
    if shard_axis is not None:
        record_build("sharded")
    else:
        record_build("fused" if batch is None else "batched")
    op = sig[0] if isinstance(sig[0], str) else sig_op(sig)
    if op != "spmm" and dsig is not None:
        raise PlanBuildError(
            f"op {op!r} does not take a delta sidecar; fold structural "
            "deltas (DynamicPlan compaction) before dispatching it")
    if shard_axis is not None and op != "spmm":
        raise PlanBuildError(
            "the sharded flavour exists for the SpMM body only; sddmm on a "
            "sharded plan runs its flat gather form, and spspmm one "
            "device's numeric phase")
    if op == "sddmm_flat":
        run = _sddmm_flat_body(sig)
        return run if batch is None else _batched_sddmm(run)
    if op == "spspmm":
        return _spspmm_body(sig)
    if op == "sddmm":
        run = _sddmm_body(sig)
        return run if batch is None else _batched_sddmm(run)
    if op != "spmm":
        raise PlanBuildError(f"operator {op!r} is not ported")
    run = _fused_body(sig)
    if dsig is not None:
        run = _with_delta(run, sig, dsig)
    if batch is not None:
        run = _batched(run)
    return run if shard_axis is None else _sharded(run, shard_axis)


def build_executor(sig: Tuple, *, batch: Optional[int] = None,
                   delta_sig: Optional[Tuple] = None,
                   shard_axis: Optional[str] = None):
    """Build (or fetch) the executor for one plan structure and operator.

    For an SpMM signature the returned callable takes ``(*plan_leaves, b,
    derived=None, a_flag=None)`` with the 17 leaves of
    ``plan_ir.plan_leaves``; ``b`` is (K, N), or (batch, K, N) when
    ``batch`` is set.  ``delta_sig`` (an SpMM signature only) adds a
    sidecar: the callable then takes ``(*plan_leaves, *delta.leaves, b,
    derived=None, a_flag=None, delta_derived=None)``.  For an
    SDDMM-tagged signature it takes ``(*plan_ir.sddmm_body_leaves(...), x,
    y, derived=None)``, batched along a leading axis of both operands when
    ``batch`` is set.  For a ``("spspmm", ...)`` signature it takes ``(ae,
    be, lengths, va, vb)`` (:func:`_spspmm_body`), and for a
    ``("sddmm_flat", ...)`` one ``(w_indptr, w_cols, w_pos, x, y)``
    (:func:`_sddmm_flat_body`), batched as the SDDMM body is.

    ``shard_axis`` ("rows" or "rhs", an SpMM signature only: the
    mesh-uniform per-shard signature of a ``ShardedPlan``) builds the
    sharded flavour, :func:`_sharded` over the same body: it takes
    ``(shards, assemble, deltas, b)``.  Its cache key carries the axis, so
    it never aliases the single-device executor of an equal signature.
    """
    if shard_axis not in (None, "rows", "rhs"):
        raise PlanBuildError(
            f"shard_axis must be rows|rhs, got {shard_axis!r}")
    key = ((sig, batch, delta_sig) if shard_axis is None
           else (sig, batch, delta_sig, "sharded", shard_axis))
    return EXECUTOR_CACHE.get_or_build(
        key, functools.partial(_build, sig, batch, delta_sig, shard_axis))


def build_delta_only_executor(m: int, bk_cfg: int, impl: str, fringe_chunk,
                              dsig: Tuple, batch: Optional[int]):
    """The sidecar's contribution on its own: ``(*delta.leaves, col_perm,
    b, derived=None)``, as the reference's compat executor (the
    differential baseline of ``execute_delta_contribution``)."""
    key = ("delta_only", m, bk_cfg, impl, fringe_chunk, dsig, batch)

    def builder():
        record_build("delta_only")
        contrib = _delta_contrib_body(m, bk_cfg, impl, False, fringe_chunk,
                                      dsig)
        return contrib if batch is None else _batched(contrib)

    return EXECUTOR_CACHE.get_or_build(key, builder)

