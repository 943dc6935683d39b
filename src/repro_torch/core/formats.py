"""Sparse containers and structure scans used by plan building.

- ``COOMatrix``        — row-sorted, padded COO triplets as tensors (the
                         vector-path layout: the gather kernel walks a row's
                         nonzeros contiguously).
- ``CSRMatrix``        — host-side scratch for preprocessing scans.
- ``BlockELL``         — the windowed, block-compacted format of the matrix
                         path: ``bm``-row windows, each storing only its
                         active ``bk``-wide column blocks.  A dataclass of
                         tensors (the reference's is a JAX pytree).
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

Host-side constructors, scans and packers are numpy, copies of
``repro.core.formats``; the built containers hold tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .arrays import sorted_unique


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


def coo_from_dense(a: np.ndarray, pad_to: int = 8,
                   device: str = "cpu") -> COOMatrix:
    """Build a row-sorted, padded COOMatrix from a dense numpy array."""
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    return coo_from_arrays(rows, cols, vals, a.shape, pad_to=pad_to,
                           device=device)


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


# ---------------------------------------------------------------------------
# CSR (host-side scratch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CSRMatrix:
    indptr: np.ndarray  # (m+1,)
    indices: np.ndarray  # (nnz,)
    data: np.ndarray  # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)


def csr_from_coo_np(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape: Tuple[int, int]
) -> CSRMatrix:
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRMatrix(indptr=indptr, indices=cols.astype(np.int32), data=vals,
                     shape=tuple(shape))


def csr_from_dense(a: np.ndarray) -> CSRMatrix:
    rows, cols = np.nonzero(a)
    return csr_from_coo_np(rows.astype(np.int32), cols.astype(np.int32),
                           a[rows, cols], a.shape)


# ---------------------------------------------------------------------------
# BlockELL — the matrix-path execution format
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BlockELL:
    """Windowed, block-compacted sparse format for the matrix path.

    Rows are grouped into ``num_windows`` windows of ``bm`` rows.  Each window
    stores up to ``max_blocks`` *active* ``bk``-wide column blocks.  Inactive
    slots point at block 0 with all-zero values.  ``row_map`` maps a packed
    row back to its original row (-1 for the padding rows of the last
    window).
    """

    block_cols: torch.Tensor  # (num_windows, max_blocks) int32 — column-block ids
    num_blocks: torch.Tensor  # (num_windows,) int32 — active block count per window
    values: torch.Tensor      # (num_windows, max_blocks, bm, bk)
    row_map: torch.Tensor     # (num_windows * bm,) int32 — packed row -> original row
    shape: Tuple[int, int]
    bm: int
    bk: int
    nnz: int

    @property
    def num_windows(self) -> int:
        return int(self.block_cols.shape[0])

    @property
    def max_blocks(self) -> int:
        return int(self.block_cols.shape[1])

    @property
    def tile_density(self) -> float:
        """Mean nonzero fraction inside stored (active) tiles."""
        total = float(self.num_blocks.sum().item()) * self.bm * self.bk
        return self.nnz / total if total else 0.0


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


def block_ell_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    bm: int,
    bk: int,
    row_order: np.ndarray | None = None,
    max_blocks: int | None = None,
    dtype=np.float32,
    device: str = "cpu",
) -> BlockELL:
    """Pack COO triplets into BlockELL, optionally under a row permutation.

    ``row_order`` gives the packed order of original rows (reordering output);
    identity if None.  Windows are consecutive ``bm``-row groups of that order.
    """
    m, k = shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if row_order is None:
        row_order = np.arange(m, dtype=np.int64)
    else:
        row_order = np.asarray(row_order, np.int64)
    if row_order.shape[0] != m:
        raise ValueError("row_order must cover every row")

    inv = np.empty(m, np.int64)
    inv[row_order] = np.arange(m)
    prow = inv[rows]  # packed row index of each nnz

    num_windows = (m + bm - 1) // bm
    m_pad = num_windows * bm
    wids = prow // bm
    kblk = cols // bk
    num_kblocks = (k + bk - 1) // bk

    st = block_structure_from_coo(wids, kblk, num_windows, num_kblocks)
    if max_blocks is None:
        max_blocks = st.max_blocks
    elif st.max_blocks > max_blocks and st.counts.size:
        raise ValueError(
            f"max_blocks={max_blocks} < needed {st.max_blocks}"
        )

    block_cols = np.zeros((num_windows, max_blocks), np.int32)
    block_cols[st.uw, st.slot] = st.ub.astype(np.int32)
    num_blocks = st.counts.astype(np.int32)

    # accumulate on flat linear indices: 1-D np.add.at keeps duplicate-sum
    # semantics
    nz_slot = st.slot[st.inv_idx]
    lin = ((wids * max_blocks + nz_slot) * bm + prow % bm) * bk + cols % bk
    values = np.zeros(num_windows * max_blocks * bm * bk, dtype)
    np.add.at(values, lin, vals.astype(dtype))
    values = values.reshape(num_windows, max_blocks, bm, bk)

    row_map = np.full(m_pad, -1, np.int64)
    row_map[: m] = row_order
    return BlockELL(
        block_cols=torch.from_numpy(block_cols).to(device),
        num_blocks=torch.from_numpy(num_blocks).to(device),
        values=torch.from_numpy(values).to(device),
        row_map=torch.from_numpy(row_map.astype(np.int32)).to(device),
        shape=tuple(shape),
        bm=bm,
        bk=bk,
        nnz=int(vals.shape[0]),
    )


def dense_from_block_ell(be: BlockELL) -> np.ndarray:
    """Reconstruct the dense matrix (oracle / tests)."""
    m, k = be.shape
    vv = be.values.cpu().numpy()
    out = np.zeros((m, k), vv.dtype)
    bc = be.block_cols.cpu().numpy()
    nb = be.num_blocks.cpu().numpy()
    rm = be.row_map.cpu().numpy()
    for w in range(be.num_windows):
        for s in range(int(nb[w])):
            c0 = int(bc[w, s]) * be.bk
            klen = min(be.bk, k - c0)
            for i in range(be.bm):
                orig = rm[w * be.bm + i]
                if orig < 0:
                    continue
                out[orig, c0 : c0 + klen] += vv[w, s, i, :klen]
    return out


def active_tile_zero_fraction(
    rows: np.ndarray, cols: np.ndarray, shape: Tuple[int, int], t: int
) -> float:
    """Fraction of zeros inside active t×t tiles (paper Table 1 metric)."""
    m, k = shape
    tr = np.asarray(rows) // t
    tc = np.asarray(cols) // t
    keys = tr.astype(np.int64) * ((k + t - 1) // t) + tc
    active = sorted_unique(keys).size
    if active == 0:
        return 0.0
    total_cells = active * t * t
    return 1.0 - len(rows) / total_cells


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
    cell = sorted_unique(rows * np.int64(k) + cols)
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
