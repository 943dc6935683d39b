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

A signature tagged with ``plan_ir.tag_op(sig, "sddmm", ...)`` selects the
SDDMM body instead, on the same plan structure: the values at the plan's
core slots (``core_lin``) on the matrix path, per-nonzero dots on the
vector path, merged in the input COO order.

Executors live in the bounded LRU ``exec.cache.EXECUTOR_CACHE`` keyed by
(signature, batch); a tagged signature never equals an untagged one, so an
SDDMM executor never aliases an SpMM one.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.plan_ir import (
    gather_rows, op_extra, permute_pad_b, sig_op, untag_sig,
)
from ..errors import PlanBuildError
from ..kernels import ops
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

    def run_batched(*args, derived=None, a_flag=None):
        *leaves, b = args
        batch, k, n = b.shape
        folded = b.permute(1, 0, 2).reshape(k, batch * n)
        out = run(*leaves, folded, derived=derived, a_flag=a_flag)
        return out.reshape(out.shape[0], batch, n).permute(1, 0, 2)

    return run_batched


def _build(sig: Tuple, batch: Optional[int]):
    record_build("fused" if batch is None else "batched")
    op = sig_op(sig)
    if op == "sddmm":
        run = _sddmm_body(sig)
        return run if batch is None else _batched_sddmm(run)
    if op != "spmm":
        raise PlanBuildError(f"operator {op!r} is not ported")
    run = _fused_body(sig)
    return run if batch is None else _batched(run)


def build_executor(sig: Tuple, *, batch: Optional[int] = None):
    """Build (or fetch) the executor for one plan structure and operator.

    For an SpMM signature the returned callable takes ``(*plan_leaves, b,
    derived=None, a_flag=None)`` with the 17 leaves of
    ``plan_ir.plan_leaves``; ``b`` is (K, N), or (batch, K, N) when
    ``batch`` is set.  For an SDDMM-tagged signature it takes
    ``(*plan_ir.sddmm_body_leaves(...), x, y, derived=None)``, batched
    along a leading axis of both operands when ``batch`` is set.
    """
    return EXECUTOR_CACHE.get_or_build(
        (sig, batch), functools.partial(_build, sig, batch))

