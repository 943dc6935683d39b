"""Executor pipeline: the fused body for a plan signature.

The fused body runs both engine paths and merges them without a scatter:

    matrix path (block_stream_spmm) -> gather_rows(packed, gather_src_matrix)
    vector path (fringe_spmm)       -> gather_rows(packed, gather_src_vector)
    C = sum of the two

A batched (batch, K, N) operand is folded into columns, (K, batch*N), so
each path launches once for the whole batch and the output is unfolded to
(batch, M, N): the port's replacement for the reference's ``vmap``.  Only
the general matrix format exists in this port.

Executors live in the bounded LRU ``exec.cache.EXECUTOR_CACHE`` keyed by
(signature, batch).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.plan_ir import gather_rows, permute_pad_b
from ..errors import PlanBuildError
from ..kernels import ops
from .cache import EXECUTOR_CACHE, record_build


def _fused_body(sig: Tuple):
    """Fused executor body for a plan signature.

    Returns ``run(*plan_leaves, b, derived=None)`` for a single (K, N)
    operand; ``derived`` is the plan's cache of kernel-side index arrays.
    """
    (_version, shape, bm, bk, _bn, impl, reorder_cols, fringe_chunk,
     num_windows, _num_steps, _nnz_f, n_fringe_rows, has_core, has_fringe,
     fringe_tier, fringe_bk, _n_chunks, _nnz_kb,
     matrix_format, _format_params) = sig
    if matrix_format != "general":
        raise PlanBuildError(
            f"matrix_format={matrix_format!r} is not ported yet (ROADMAP A8)")
    m, _k = shape

    def run(step_window, step_col, flat_values, fringe_rows, fringe_cols,
            fringe_vals, col_perm, gsrc_m, gsrc_v,
            kb_chunk, kb_rows, kb_cols, kb_vals,
            _nm_values, _nm_codes, _bitmap_words, _bitmap_values, b,
            derived: Optional[Dict[str, Any]] = None):
        n = b.shape[1]
        bp = permute_pad_b(b, col_perm, reorder_cols, bk)
        c = None
        if has_core:
            packed_m = ops.block_stream_spmm(
                step_window, step_col, flat_values, bp,
                num_windows=num_windows, bm=bm, bk=bk, impl=impl,
                derived=derived,
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


def _batched(run):
    """Fold a (batch, K, N) operand into (K, batch*N), run once, unfold."""

    def run_batched(*args, derived=None):
        *leaves, b = args
        batch, k, n = b.shape
        folded = b.permute(1, 0, 2).reshape(k, batch * n)
        out = run(*leaves, folded, derived=derived)
        return out.reshape(out.shape[0], batch, n).permute(1, 0, 2)

    return run_batched


def _build(sig: Tuple, batch: Optional[int]):
    record_build("fused" if batch is None else "batched")
    run = _fused_body(sig)
    return run if batch is None else _batched(run)


def build_executor(sig: Tuple, *, batch: Optional[int] = None):
    """Build (or fetch) the executor for one plan structure.

    The returned callable takes ``(*plan_leaves, b, derived=None)`` with
    the 17 leaves of ``plan_ir.plan_leaves``; ``b`` is (K, N), or
    (batch, K, N) when ``batch`` is set.
    """
    return EXECUTOR_CACHE.get_or_build(
        (sig, batch), functools.partial(_build, sig, batch))

