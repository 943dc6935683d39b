"""Sparse containers and structure scans used by plan building.

- ``COOMatrix``        — row-sorted, padded COO triplets as tensors (the
                         vector-path layout: the gather kernel walks a row's
                         nonzeros contiguously).
- ``BlockStructure``   — the active (window, k-block) pairs of the dense
                         core: the skeleton of the flat tile stream.
- ``detect_nm_pattern`` — N:M column-group detection, which ``prepare``
                         runs to refuse matrices the structured lane would
                         take (that lane is not ported yet).

Host-side scans are numpy, as in ``repro.core.formats``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class COOMatrix:
    """Row-sorted COO. ``shape`` is static metadata."""

    rows: torch.Tensor  # (nnz_padded,) int32, row-sorted; padding repeats last row
    cols: torch.Tensor  # (nnz_padded,) int32; padding = 0
    vals: torch.Tensor  # (nnz_padded,) float;  padding = 0.0
    shape: Tuple[int, int]
    nnz: int  # true (unpadded) nonzero count

    @property
    def density(self) -> float:
        m, k = self.shape
        return self.nnz / float(max(m * k, 1))


def coo_from_arrays(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    pad_to: int = 8,
    device: str = "cpu",
) -> COOMatrix:
    """Row-sort and pad raw COO triplets."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    nnz = int(rows.shape[0])
    padded = max(pad_to, ((nnz + pad_to - 1) // pad_to) * pad_to) if nnz else pad_to
    pad = padded - nnz
    if pad:
        last_row = rows[-1] if nnz else np.int32(0)
        rows = np.concatenate([rows, np.full(pad, last_row, np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])
        vals = np.concatenate(
            [vals, np.zeros(pad, vals.dtype if nnz else np.float32)])
    return COOMatrix(
        rows=torch.from_numpy(rows).to(device),
        cols=torch.from_numpy(cols).to(device),
        vals=torch.from_numpy(vals).to(device),
        shape=tuple(shape),
        nnz=nnz,
    )


def dense_from_coo(coo: COOMatrix) -> np.ndarray:
    vals = coo.vals[: coo.nnz].cpu().numpy()
    out = np.zeros(coo.shape, dtype=vals.dtype)
    rows = coo.rows[: coo.nnz].cpu().numpy()
    cols = coo.cols[: coo.nnz].cpu().numpy()
    np.add.at(out, (rows, cols), vals)
    return out


@dataclasses.dataclass
class BlockStructure:
    """Active (window, k-block) pairs of a packed sparse matrix.

    ``uw[p]``/``ub[p]`` give pair p's window and k-block id, ``slot[p]`` its
    position among the window's active blocks, and ``inv_idx[i]`` the pair
    owning nonzero i.  Pairs are sorted by (window, k-block).
    """

    uw: np.ndarray       # (P,) window id per active pair
    ub: np.ndarray       # (P,) k-block id per active pair
    slot: np.ndarray     # (P,) slot of the pair within its window
    inv_idx: np.ndarray  # (nnz,) pair index of each nonzero
    counts: np.ndarray   # (num_windows,) active blocks per window
    max_blocks: int      # max(counts) (>= 1)


def block_structure_from_coo(
    wids: np.ndarray, kblk: np.ndarray, num_windows: int, num_kblocks: int
) -> BlockStructure:
    """Compute the active-pair skeleton from per-nonzero window/k-block ids."""
    keys = wids * num_kblocks + kblk
    uniq, inv_idx = np.unique(keys, return_inverse=True)
    uw = (uniq // num_kblocks).astype(np.int64)
    ub = (uniq % num_kblocks).astype(np.int64)
    counts = np.bincount(uw, minlength=num_windows)
    slot = np.zeros(uniq.shape[0], np.int64)
    if uniq.size:
        first = np.concatenate([[True], uw[1:] != uw[:-1]])
        run_start = np.maximum.accumulate(
            np.where(first, np.arange(uniq.size), 0)
        )
        slot = np.arange(uniq.size) - run_start
    max_blocks = int(counts.max()) if counts.size else 1
    return BlockStructure(
        uw=uw, ub=ub, slot=slot, inv_idx=inv_idx, counts=counts,
        max_blocks=max(1, max_blocks),
    )


NM_CANDIDATE_M = (4, 8, 16, 32)
NM_MAX_KEEP_FRACTION = 0.5   # n/m above this is not worth a fast lane
NM_MIN_GROUP_FILL = 0.95     # occupied groups must be ~uniformly n-full
NM_MAX_N = 4                 # position codes pack 8 bits per slot


def detect_nm_pattern(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    candidates: Tuple[int, ...] = NM_CANDIDATE_M,
) -> Tuple[int, int] | None:
    """Detect an N:M column-group pattern in a COO sparsity structure.

    Returns the ``(n, m)`` candidate with the best packed-bytes ratio
    (``(n + 1) / m``) among those whose per-(row, m-group) nonzero counts
    are bounded by an ``n`` that is sparse enough
    (``n/m <= NM_MAX_KEEP_FRACTION``, ``n <= NM_MAX_N``) and tight
    (occupied groups are near-uniformly n-full, ``NM_MIN_GROUP_FILL``).
    Duplicate COO entries count once.  None means no usable pattern.
    """
    m, k = shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size == 0:
        return None
    cell = np.unique(rows * np.int64(k) + cols)
    ucols = cell % k
    best = None
    for m_pat in candidates:
        counts = np.unique((cell // k) * np.int64((k + m_pat - 1) // m_pat)
                           + ucols // m_pat, return_counts=True)[1]
        n_pat = int(counts.max())
        if n_pat > NM_MAX_N or n_pat > m_pat * NM_MAX_KEEP_FRACTION:
            continue
        fill = cell.size / float(n_pat * counts.size)
        if fill < NM_MIN_GROUP_FILL:
            continue
        ratio = (n_pat + 1) / m_pat
        if best is None or ratio < best[0]:
            best = (ratio, n_pat, m_pat)
    return (best[1], best[2]) if best is not None else None
