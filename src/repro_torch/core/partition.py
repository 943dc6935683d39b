"""Heterogeneous workload partitioning (paper §5.2.2).

Two-stage row-column extraction splits A into
- a *dense core* (rows and columns whose nonzero length exceeds the
  alpha-derived threshold) destined for the matrix/MXU path, and
- *sparse fringes* (short rows, plus short columns extracted from the dense
  rows) destined for the vector/gather path.

Both paths contribute to the same output C = A @ B:
- the core's packed rows scatter into C via the BlockELL ``row_map``;
- the fringe COO scatter-adds by original row id.

Everything here is one-time host-side preprocessing (numpy), matching the
paper's single-linear-scan cost profile.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .arrays import sorted_unique
from .cost_model import EngineCostModel


@dataclasses.dataclass
class PartitionResult:
    """Host-side split of A's nonzeros into matrix-path and vector-path sets."""

    # matrix path ("AIC"): triplets of the dense core
    core_rows: np.ndarray
    core_cols: np.ndarray
    core_vals: np.ndarray
    core_row_ids: np.ndarray  # original row ids participating in the core

    # vector path ("AIV"): fringe triplets
    fringe_rows: np.ndarray
    fringe_cols: np.ndarray
    fringe_vals: np.ndarray

    shape: Tuple[int, int]
    alpha: float
    row_threshold: float
    col_threshold: float

    # provenance: position of each core/fringe triplet in the caller's input
    # arrays (parallel to core_*/fringe_*).  The dynamic-update subsystem
    # inverts these into COO->slot maps at prepare() time; None when the
    # split came from a migration that did not carry indices.
    core_idx: Optional[np.ndarray] = None
    fringe_idx: Optional[np.ndarray] = None

    @property
    def core_nnz(self) -> int:
        return int(self.core_rows.shape[0])

    @property
    def fringe_nnz(self) -> int:
        return int(self.fringe_rows.shape[0])

    @property
    def nnz(self) -> int:
        return self.core_nnz + self.fringe_nnz

    def fringe_fraction(self) -> float:
        return self.fringe_nnz / max(self.nnz, 1)


def partition_rows_cols(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    cost_model: EngineCostModel,
    alpha: Optional[float] = None,
    col_stage: bool = True,
) -> PartitionResult:
    """Two-stage extraction (Fig. 9): rows first, then columns of the core.

    Stage 1: rows with Len(row) <= alpha*K -> fringe (A2).
    Stage 2: within the remaining dense rows (A1), columns with
             Len(col within A1) <= alpha*M1 -> fringe (A12); rest is the
             dense core (A11).
    """
    m, k = shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    idx = np.arange(rows.shape[0], dtype=np.int64)
    a = cost_model.alpha if alpha is None else float(alpha)

    # --- stage 1: row extraction (Eq. 4/5) ---
    row_len = np.bincount(rows, minlength=m)
    row_thres = a * k
    sparse_row = row_len <= row_thres  # Len(v) <= Thres -> vector path
    nz_sparse_row = sparse_row[rows]

    f_rows = [rows[nz_sparse_row]]
    f_cols = [cols[nz_sparse_row]]
    f_vals = [vals[nz_sparse_row]]
    f_idx = [idx[nz_sparse_row]]

    d_rows = rows[~nz_sparse_row]
    d_cols = cols[~nz_sparse_row]
    d_vals = vals[~nz_sparse_row]
    d_idx = idx[~nz_sparse_row]

    # --- stage 2: column extraction within the dense rows ---
    col_thres = 0.0
    if col_stage and d_rows.size:
        m1 = int(np.count_nonzero(np.bincount(d_rows, minlength=m)))
        col_len = np.bincount(d_cols, minlength=k)
        col_thres = a * m1
        sparse_col = col_len <= col_thres
        nz_sparse_col = sparse_col[d_cols]
        f_rows.append(d_rows[nz_sparse_col])
        f_cols.append(d_cols[nz_sparse_col])
        f_vals.append(d_vals[nz_sparse_col])
        f_idx.append(d_idx[nz_sparse_col])
        d_rows = d_rows[~nz_sparse_col]
        d_cols = d_cols[~nz_sparse_col]
        d_vals = d_vals[~nz_sparse_col]
        d_idx = d_idx[~nz_sparse_col]

    fringe_rows = np.concatenate(f_rows) if f_rows else np.zeros(0, np.int64)
    fringe_cols = np.concatenate(f_cols) if f_cols else np.zeros(0, np.int64)
    fringe_vals = (
        np.concatenate(f_vals) if f_vals else np.zeros(0, vals.dtype)
    )
    fringe_idx = np.concatenate(f_idx) if f_idx else np.zeros(0, np.int64)

    core_row_ids = (
        np.flatnonzero(np.bincount(d_rows, minlength=m))
        if d_rows.size else np.zeros(0, np.int64)
    )

    return PartitionResult(
        core_rows=d_rows,
        core_cols=d_cols,
        core_vals=d_vals,
        core_row_ids=core_row_ids,
        fringe_rows=fringe_rows,
        fringe_cols=fringe_cols,
        fringe_vals=fringe_vals,
        shape=tuple(shape),
        alpha=a,
        row_threshold=float(row_thres),
        col_threshold=float(col_thres),
        core_idx=d_idx,
        fringe_idx=fringe_idx,
    )


def migrate_core_to_fringe(
    part: PartitionResult, window_ids: np.ndarray, row_window: np.ndarray
) -> PartitionResult:
    """Move the nonzeros of the given core row-windows to the fringe set.

    ``row_window[r]`` gives the window id of original row r (or -1).  Used by
    the adaptive coordinator when the matrix path is the bottleneck
    (paper §5.3: decompose sparse tiles back into index-value lists).
    """
    move = np.isin(row_window[part.core_rows], window_ids)
    has_idx = part.core_idx is not None and part.fringe_idx is not None
    return dataclasses.replace(
        part,
        core_rows=part.core_rows[~move],
        core_cols=part.core_cols[~move],
        core_vals=part.core_vals[~move],
        core_row_ids=sorted_unique(part.core_rows[~move]) if (~move).any() else np.zeros(0, np.int64),
        fringe_rows=np.concatenate([part.fringe_rows, part.core_rows[move]]),
        fringe_cols=np.concatenate([part.fringe_cols, part.core_cols[move]]),
        fringe_vals=np.concatenate([part.fringe_vals, part.core_vals[move]]),
        core_idx=part.core_idx[~move] if has_idx else None,
        fringe_idx=(
            np.concatenate([part.fringe_idx, part.core_idx[move]])
            if has_idx else None
        ),
    )


def migrate_fringe_to_core(part: PartitionResult, row_ids: np.ndarray) -> PartitionResult:
    """Densify: move all fringe nonzeros of the given rows into the core
    (paper §5.3: merge denser rows/segments into matrix tiles)."""
    move = np.isin(part.fringe_rows, row_ids)
    new_core_rows = np.concatenate([part.core_rows, part.fringe_rows[move]])
    has_idx = part.core_idx is not None and part.fringe_idx is not None
    return dataclasses.replace(
        part,
        core_rows=new_core_rows,
        core_cols=np.concatenate([part.core_cols, part.fringe_cols[move]]),
        core_vals=np.concatenate([part.core_vals, part.fringe_vals[move]]),
        core_row_ids=sorted_unique(new_core_rows),
        fringe_rows=part.fringe_rows[~move],
        fringe_cols=part.fringe_cols[~move],
        fringe_vals=part.fringe_vals[~move],
        core_idx=(
            np.concatenate([part.core_idx, part.fringe_idx[move]])
            if has_idx else None
        ),
        fringe_idx=part.fringe_idx[~move] if has_idx else None,
    )
