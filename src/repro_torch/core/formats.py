"""Sparse containers and structure scans used by plan building.

- ``COOMatrix``        — row-sorted, padded COO triplets as tensors (the
                         vector-path layout: the gather kernel walks a row's
                         nonzeros contiguously).
- ``BlockStructure``   — the active (window, k-block) pairs of the dense
                         core: the skeleton of the flat tile stream.
- ``detect_nm_pattern`` / ``detect_block_diagonal`` — structure scans
                         ``prepare`` runs to choose the matrix-path payload.
- ``pack_nm_tiles`` / ``pack_bitmap_tiles`` (and their inverses) — the two
                         packed encodings of the flat (T, bm, bk) tile
                         stream that the structured lane's kernels read:

  - N:M: every m consecutive columns of a tile row hold at most n nonzeros.
    Payload: per-(row, group) values in slot-major layout plus one int32
    position code (8 bits per slot, so n <= 4).
  - bitmap: per-tile-row occupancy bits packed into int32 words plus a
    row-capacity-padded value stream (column order).

  Both round-trip exactly (``pack -> unpack`` is the identity on the tile
  stream) and both are payload-only alternatives: the general stream is
  always kept beside them, so SDDMM and value updates keep reading it.

Host-side scans and packers are numpy, copies of ``repro.core.formats``.
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
BITMAP_WORD_BITS = 32


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


def detect_block_diagonal(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    candidates: Tuple[int, ...] = (32, 64, 128, 256),
) -> int | None:
    """Largest candidate block size under which the matrix is block-diagonal
    (every nonzero satisfies ``row // bs == col // bs``), or None.

    A block size that covers half the matrix or more is not counted (one
    block would be the whole matrix).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size == 0:
        return None
    for bs in sorted(candidates, reverse=True):
        if bs * 2 > min(shape):
            continue
        if np.all(rows // bs == cols // bs):
            return bs
    return None


def pack_nm_tiles(
    flat_values: np.ndarray, n_pat: int, m_pat: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a flat (T, bm, bk) tile stream into the N:M payload.

    Returns ``(nm_values, nm_codes)``:

    - ``nm_values`` (T, bm, n*gk) float32, slot-major: slot j of every
      group is the contiguous span ``[:, j*gk:(j+1)*gk]``;
    - ``nm_codes`` (T, bm, gk) int32: slot j's within-group position in bits
      ``[8j, 8j+8)``.  Empty slots carry position 0 with value 0.0 (they
      select a cell but add 0).

    Raises ``ValueError`` if any group holds more than ``n_pat`` nonzeros.
    """
    t, bm, bk = flat_values.shape
    if bk % m_pat:
        raise ValueError(f"bk={bk} is not a multiple of m={m_pat}")
    if not (1 <= n_pat <= NM_MAX_N):
        raise ValueError(f"n={n_pat} outside the packable range [1, {NM_MAX_N}]")
    gk = bk // m_pat
    g = np.ascontiguousarray(flat_values, np.float32).reshape(
        t, bm, gk, m_pat
    )
    nz = g != 0.0
    counts = nz.sum(axis=-1)
    if counts.size and int(counts.max()) > n_pat:
        raise ValueError(
            f"tile stream violates {n_pat}:{m_pat} — a column group holds "
            f"{int(counts.max())} nonzeros"
        )
    # stable order: nonzeros first (by position), then zero slots
    order = np.argsort(~nz, axis=-1, kind="stable")
    top = order[..., :n_pat].astype(np.int64)           # (T, bm, gk, n)
    vals = np.take_along_axis(g, top, axis=-1)          # (T, bm, gk, n)
    top = np.where(vals != 0.0, top, 0)  # zero slots encode position 0
    codes = np.zeros((t, bm, gk), np.int64)
    for j in range(n_pat):
        codes |= top[..., j] << (8 * j)
    # slot-major value layout: (T, bm, n, gk) -> (T, bm, n*gk)
    nm_values = np.ascontiguousarray(
        vals.transpose(0, 1, 3, 2)
    ).reshape(t, bm, n_pat * gk).astype(np.float32)
    return nm_values, codes.astype(np.int32)


def unpack_nm_tiles(
    nm_values: np.ndarray, nm_codes: np.ndarray, n_pat: int, m_pat: int
) -> np.ndarray:
    """Expand the N:M payload back to the flat (T, bm, bk) tile stream."""
    t, bm, gk = nm_codes.shape
    bk = gk * m_pat
    out = np.zeros((t, bm, gk, m_pat), np.float32)
    codes = nm_codes.astype(np.int64)
    for j in range(n_pat):
        pos = (codes >> (8 * j)) & 0xFF                # (T, bm, gk)
        val = nm_values[:, :, j * gk : (j + 1) * gk]   # (T, bm, gk)
        np.add.at(
            out,
            (np.arange(t)[:, None, None], np.arange(bm)[None, :, None],
             np.arange(gk)[None, None, :], pos),
            np.where(val != 0.0, val, 0.0),
        )
    return out.reshape(t, bm, bk)


def pack_bitmap_tiles(
    flat_values: np.ndarray, min_row_cap: int = 8
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack a flat (T, bm, bk) tile stream into the bitmap payload.

    Returns ``(bitmap_words, bitmap_values, row_cap)``:

    - ``bitmap_words`` (T, bm, ceil(bk/32)) int32: bit c of word c//32 set
      iff column c of the tile row is nonzero;
    - ``bitmap_values`` (T, bm, row_cap) float32: each row's nonzeros in
      column order, zero-padded to ``row_cap`` (the max per-row count,
      rounded up to a multiple of ``min_row_cap``).
    """
    t, bm, bk = flat_values.shape
    g = np.ascontiguousarray(flat_values, np.float32)
    bits = g != 0.0
    counts = bits.sum(axis=-1)
    max_cnt = int(counts.max()) if counts.size else 0
    row_cap = max(
        min_row_cap,
        ((max_cnt + min_row_cap - 1) // min_row_cap) * min_row_cap,
    )
    bw = (bk + BITMAP_WORD_BITS - 1) // BITMAP_WORD_BITS
    col = np.arange(bk)
    words = np.zeros((t, bm, bw), np.uint32)
    np.bitwise_or.at(
        words,
        (np.arange(t)[:, None, None], np.arange(bm)[None, :, None],
         np.broadcast_to(col // BITMAP_WORD_BITS, (t, bm, bk))),
        np.where(bits, np.uint32(1) << (col % BITMAP_WORD_BITS).astype(
            np.uint32), np.uint32(0)),
    )
    order = np.argsort(~bits, axis=-1, kind="stable")
    packed = np.take_along_axis(g, order[..., :row_cap], axis=-1)
    packed = np.where(
        np.take_along_axis(bits, order[..., :row_cap], axis=-1), packed, 0.0
    ).astype(np.float32)
    return words.view(np.int32), packed, row_cap


def pack_bitmap_tiles_torch(
    flat_values: torch.Tensor, min_row_cap: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`pack_bitmap_tiles` on a tensor's own device (for large seeded
    streams built on the card); the same three results, as tensors."""
    t, bm, bk = flat_values.shape
    dev = flat_values.device
    g = flat_values.to(torch.float32).contiguous()
    bits = g != 0.0
    counts = bits.sum(dim=-1)
    max_cnt = int(counts.max()) if counts.numel() else 0
    row_cap = max(min_row_cap,
                  -(-max_cnt // min_row_cap) * min_row_cap)
    bw = (bk + BITMAP_WORD_BITS - 1) // BITMAP_WORD_BITS
    padded = torch.zeros((t, bm, bw * BITMAP_WORD_BITS), dtype=torch.int64,
                         device=dev)
    padded[:, :, :bk] = bits
    weights = torch.bitwise_left_shift(
        torch.ones(BITMAP_WORD_BITS, dtype=torch.int64, device=dev),
        torch.arange(BITMAP_WORD_BITS, device=dev))
    words = (padded.reshape(t, bm, bw, BITMAP_WORD_BITS) * weights).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    order = torch.sort((~bits).to(torch.int8), dim=-1, stable=True).indices
    order = order[..., :row_cap]
    if row_cap > bk:
        order = torch.cat([order, order.new_zeros((t, bm, row_cap - bk))],
                          -1)
    keep = torch.gather(bits, 2, order)
    if row_cap > bk:
        keep[..., bk:] = False
    packed = torch.where(keep, torch.gather(g, 2, order), 0.0)
    return words.to(torch.int32), packed, row_cap


def unpack_bitmap_tiles(
    bitmap_words: np.ndarray, bitmap_values: np.ndarray, bk: int
) -> np.ndarray:
    """Expand the bitmap payload back to the flat (T, bm, bk) tile stream."""
    t, bm, _bw = bitmap_words.shape
    col = np.arange(bk)
    words = bitmap_words.view(np.uint32)
    bits = (
        words[:, :, col // BITMAP_WORD_BITS]
        >> (col % BITMAP_WORD_BITS).astype(np.uint32)
    ) & np.uint32(1)
    rank = np.cumsum(bits, axis=-1) - bits      # exclusive per-row rank
    rcap = bitmap_values.shape[-1]
    gathered = np.take_along_axis(
        bitmap_values, np.minimum(rank, rcap - 1).astype(np.int64), axis=-1
    )
    return np.where(bits == 1, gathered, 0.0).astype(np.float32)
