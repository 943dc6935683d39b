"""Plain PyTorch versions of the kernels (ports of ``repro.kernels.ref``).

Every hand-written kernel of the port has its plain version here.  They
are what the ``"torch"`` impl runs on the CPU, what the tests hold against
the JAX oracles, and what the kernels are held against on the card.  They
use ordinary tensor ops (batched matmul, ``index_add_``) and are no
yardstick of speed.
"""
from __future__ import annotations

from typing import Optional

import torch


def ref_spmm_dense(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with fp32 accumulation."""
    return a_dense.to(torch.float32) @ b.to(torch.float32)


def ref_block_stream_spmm(
    step_window: torch.Tensor,  # (T,) int32 — destination window of each step
    step_col: torch.Tensor,     # (T,) int32 — B k-block id of each step
    flat_values: torch.Tensor,  # (T, bm, bk)
    b: torch.Tensor,            # (K, N), K a multiple of bk
    num_windows: int,
    tile_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Flat block stream: for each step t,
    out[step_window[t]] += values[t] @ B[step_col[t]*bk : +bk].
    Returns packed (num_windows*bm, N) fp32.

    ``tile_chunk`` bounds the gathered (chunk, bk, N) B blocks and the
    (chunk, bm, N) partial products; None takes the whole stream at once.
    """
    t, bm, bk = flat_values.shape
    n = b.shape[1]
    b_blocks = b.to(torch.float32).reshape(-1, bk, n)  # (K//bk, bk, N)
    out = torch.zeros((num_windows, bm, n), dtype=torch.float32,
                      device=b.device)
    step = t if tile_chunk is None else max(1, int(tile_chunk))
    for s in range(0, t, step):
        cols = step_col[s:s + step].long()
        partial = torch.bmm(flat_values[s:s + step].to(torch.float32),
                            b_blocks[cols])
        out.index_add_(0, step_window[s:s + step].long(), partial)
    return out.reshape(num_windows * bm, n)


def densified_block_stream_spmm(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    flat_values: torch.Tensor,  # (T, bm, bk)
    b: torch.Tensor,            # (K, N) — K a multiple of bk
    num_windows: int,
) -> torch.Tensor:
    """High-occupancy form of the flat block stream: sum the tiles back into
    a densified (num_windows*bm, K) core and issue one matmul.  The densify
    is add-based, so duplicate (window, k-block) pairs accumulate like the
    streaming form.  Returns packed (num_windows*bm, N) fp32."""
    t, bm, bk = flat_values.shape
    k, n = b.shape
    nkb = k // bk
    lin = step_window.long() * nkb + step_col.long()
    perm = torch.argsort(lin, stable=True)
    tiles = torch.zeros((num_windows * nkb, bm, bk), dtype=torch.float32,
                        device=b.device)
    tiles.index_add_(0, lin[perm], flat_values.to(torch.float32)[perm])
    core = tiles.reshape(num_windows, nkb, bm, bk).permute(0, 2, 1, 3)
    return core.reshape(num_windows * bm, k) @ b.to(torch.float32)


def densified_block_stream_spmm_unique(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    flat_values: torch.Tensor,  # (T, bm, bk)
    b: torch.Tensor,            # (K, N) — K a multiple of bk
    num_windows: int,
) -> torch.Tensor:
    """Densified matmul for streams with unique (window, k-block) pairs —
    the invariant ``prepare()`` guarantees.  Scatters only the T slot
    indices, then densifies by gathering tiles; with duplicate pairs it
    keeps one tile per slot.  Returns packed (num_windows*bm, N) fp32."""
    t, bm, bk = flat_values.shape
    k, n = b.shape
    nkb = k // bk
    slot = torch.full((num_windows, nkb), t, dtype=torch.long,
                      device=b.device)
    slot[step_window.long(), step_col.long()] = torch.arange(
        t, device=b.device)
    valid = slot < t
    tiles = flat_values.to(torch.float32)[torch.where(valid, slot, 0)]
    tiles = torch.where(valid[..., None, None], tiles, 0.0)
    core = tiles.permute(0, 2, 1, 3).reshape(num_windows * bm, k)
    return core @ b.to(torch.float32)


def ref_nm_stream_spmm(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    nm_values: torch.Tensor,    # (T, bm, n*gk) fp32 slot-major packed values
    nm_codes: torch.Tensor,     # (T, bm, gk) int32, 8-bit positions per slot
    b: torch.Tensor,            # (K, N) — K a multiple of bk
    num_windows: int,
    n_pat: int,
    m_pat: int,
    bk: int,
    tile_chunk: int = 8,
) -> torch.Tensor:
    """The N:M-packed tile stream in the reference's gather form: each
    packed value multiplies its own B row (slot positions decoded into
    global B rows), n/m of the dense-tile multiply-adds.  ``tile_chunk``
    bounds the gathered (chunk, bm, n*gk, N) B rows per step.  Returns
    packed (num_windows*bm, N) fp32."""
    t, bm, _ = nm_values.shape
    n = b.shape[1]
    gk = bk // m_pat
    q = n_pat * gk
    dev = b.device
    bf = b.to(torch.float32)
    # slot-major local columns: value [t, r, j*gk + g] sits at in-tile
    # column g*m_pat + ((codes[t, r, g] >> 8j) & 0xFF)
    shifts = 8 * torch.arange(n_pat, dtype=torch.int32, device=dev)[:, None]
    base = torch.arange(gk, dtype=torch.int64, device=dev) * m_pat
    out = torch.zeros((num_windows, bm, n), dtype=torch.float32, device=dev)
    step = max(1, min(int(tile_chunk), t))
    for s in range(0, t, step):
        pos = (nm_codes[s:s + step, :, None, :] >> shifts) & 0xFF
        cols = (pos.long() + base).reshape(-1, bm, q)
        rows = step_col[s:s + step].long()[:, None, None] * bk + cols
        contrib = torch.einsum(
            "tmq,tmqn->tmn", nm_values[s:s + step].to(torch.float32),
            bf[rows])
        out.index_add_(0, step_window[s:s + step].long(), contrib)
    return out.reshape(num_windows * bm, n)


def expand_nm_tiles(
    nm_values: torch.Tensor,  # (T, bm, n*gk) fp32 slot-major packed values
    nm_codes: torch.Tensor,   # (T, bm, gk) int32, 8-bit positions per slot
    n_pat: int,
    m_pat: int,
    bk: int,
) -> torch.Tensor:
    """Re-expand an N:M payload to the dense (T, bm, bk) fp32 stream as the
    TPU kernel's ``_nm_expand`` does: each cell the sum, in slot order from
    0.0, of the slots whose position selects it."""
    t, bm, _ = nm_values.shape
    gk = bk // m_pat
    offs = torch.arange(bk, device=nm_values.device) % m_pat
    group = torch.arange(bk, device=nm_values.device) // m_pat
    dense = torch.zeros((t, bm, bk), dtype=torch.float32,
                        device=nm_values.device)
    for j in range(n_pat):
        pos = ((nm_codes >> (8 * j)) & 0xFF)[:, :, group]
        val = nm_values[:, :, j * gk:(j + 1) * gk].to(torch.float32)
        dense = dense + torch.where(pos == offs, val[:, :, group], 0.0)
    return dense


def ref_nm_stream_spmm_dense(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    nm_values: torch.Tensor,    # (T, bm, n*gk) fp32 slot-major packed values
    nm_codes: torch.Tensor,     # (T, bm, gk) int32
    b: torch.Tensor,            # (K, N) — K a multiple of bk
    num_windows: int,
    n_pat: int,
    m_pat: int,
    bk: int,
    tile_chunk: Optional[int] = None,
) -> torch.Tensor:
    """The N:M tile stream as the TPU kernel computes it: expand every tile,
    then the general streaming product (every tile entry multiplied).  With
    finite B it equals :func:`ref_nm_stream_spmm` within fp32 rounding;
    where B holds an Inf or NaN a zero cell gives NaN here and nothing in
    the gather form.  Returns packed (num_windows*bm, N) fp32."""
    flat_values = expand_nm_tiles(nm_values, nm_codes, n_pat, m_pat, bk)
    return ref_block_stream_spmm(step_window, step_col, flat_values, b,
                                 num_windows, tile_chunk=tile_chunk)


def expand_bitmap_tiles(
    bitmap_words: torch.Tensor,   # (T, bm, ceil(bk/32)) int32 occupancy bits
    bitmap_values: torch.Tensor,  # (T, bm, row_cap) fp32 packed row values
    bk: int,
) -> torch.Tensor:
    """Re-expand a bitmap payload to the dense (T, bm, bk) fp32 stream:
    rank each set bit by a row-wise exclusive cumsum and gather its packed
    value (clamped to ``row_cap - 1``, as the reference clips).  The
    arithmetic shift is safe for bit 31: only bit 0 of the result is
    read."""
    row_cap = bitmap_values.shape[2]
    cols = torch.arange(bk, dtype=torch.int32, device=bitmap_words.device)
    bits = (bitmap_words[:, :, (cols // 32).long()] >> (cols % 32)) & 1
    rank = torch.cumsum(bits, dim=-1) - bits
    gathered = torch.gather(bitmap_values.to(torch.float32), 2,
                            rank.clamp(0, row_cap - 1).long())
    return torch.where(bits == 1, gathered, 0.0)


def ref_bitmap_stream_spmm(
    step_window: torch.Tensor,    # (T,) int32
    step_col: torch.Tensor,       # (T,) int32
    bitmap_words: torch.Tensor,   # (T, bm, ceil(bk/32)) int32
    bitmap_values: torch.Tensor,  # (T, bm, row_cap) fp32
    b: torch.Tensor,              # (K, N) — K a multiple of bk
    num_windows: int,
    bk: int,
    tile_chunk: Optional[int] = None,
) -> torch.Tensor:
    """The bitmap-packed tile stream: expand, then the general streaming
    product (``tile_chunk`` as in :func:`ref_block_stream_spmm`).
    Returns packed (num_windows*bm, N) fp32."""
    flat_values = expand_bitmap_tiles(bitmap_words, bitmap_values, bk)
    return ref_block_stream_spmm(step_window, step_col, flat_values, b,
                                 num_windows, tile_chunk=tile_chunk)


def ref_gather_spmm(
    rows: torch.Tensor,  # (nnz,) int32 packed row ids
    cols: torch.Tensor,  # (nnz,) int32
    vals: torch.Tensor,  # (nnz,)
    b: torch.Tensor,     # (K, N)
    num_rows: int,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Vector path: out[rows[i]] += vals[i] * B[cols[i]].

    ``chunk`` bounds the materialized gather to (chunk, N) per step; None
    is the one-shot form.  Returns packed (num_rows, N) fp32.
    """
    nnz = rows.shape[0]
    out = torch.zeros((num_rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    step = nnz if chunk is None or nnz <= chunk else int(chunk)
    for s in range(0, nnz, max(step, 1)):
        gathered = (b[cols[s:s + step].long()].to(torch.float32)
                    * vals[s:s + step].to(torch.float32)[:, None])
        out.index_add_(0, rows[s:s + step].long(), gathered)
    return out


def ref_gather_spmm_kblocked(
    chunk_kb: torch.Tensor,  # (num_chunks,) int32, chunk -> k-block id
    rows: torch.Tensor,  # (num_chunks*chunk,) int32 k-bucketed packed rows
    cols: torch.Tensor,  # (num_chunks*chunk,) int32 k-block-LOCAL columns
    vals: torch.Tensor,  # (num_chunks*chunk,) — zero for padding entries
    b: torch.Tensor,     # (K, N)
    num_rows: int,
    bk: int,
    step: Optional[int] = None,
) -> torch.Tensor:
    """The K-sharded streaming tier's bucketed layout: chunk c's entries
    address B rows ``chunk_kb[c]*bk + cols[i]``.  Equals
    :func:`ref_gather_spmm` on the un-bucketed stream.

    ``step`` bounds the materialized gather to (step, N) entries at a time;
    None is the one-shot form."""
    num_chunks = chunk_kb.shape[0]
    chunk = rows.shape[0] // num_chunks
    k = b.shape[0]
    k_pad = ((k + bk - 1) // bk) * bk
    if k_pad != k:
        b = torch.nn.functional.pad(b, (0, 0, 0, k_pad - k))
    global_cols = (torch.repeat_interleave(chunk_kb.long(), chunk) * bk
                   + cols.long())
    return ref_gather_spmm(rows, global_cols, vals, b, num_rows, chunk=step)


def ref_tile_sddmm(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    xp: torch.Tensor,           # (num_windows*bm, D) window-gathered X rows
    yp: torch.Tensor,           # (D, K) — K a multiple of bk
    bm: int,
    bk: int,
    tile_chunk: Optional[int] = None,
) -> torch.Tensor:
    """SDDMM matrix path: for each active tile t,
    tiles[t] = Xp[step_window[t]*bm : +bm] @ Yp[:, step_col[t]*bk : +bk].
    Returns the fp32 tile stream (T, bm, bk).

    ``tile_chunk`` bounds the gathered (chunk, bm, D) X panels and
    (chunk, D, bk) Y slabs; None takes the whole stream at once.
    """
    t = step_window.shape[0]
    d = xp.shape[1]
    xw = xp.to(torch.float32).reshape(-1, bm, d)                  # (nw, bm, D)
    yb = yp.to(torch.float32).reshape(d, -1, bk).permute(1, 0, 2)  # (nkb, D, bk)
    out = torch.empty((t, bm, bk), dtype=torch.float32, device=xp.device)
    step = max(1, t if tile_chunk is None else int(tile_chunk))
    for s in range(0, t, step):
        out[s:s + step] = torch.bmm(xw[step_window[s:s + step].long()],
                                    yb[step_col[s:s + step].long()])
    return out


def ref_tile_sddmm_at_slots(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    core_lin: torch.Tensor,     # (nnz,) int64 flat tile slot, -1 elsewhere
    xp: torch.Tensor,           # (num_windows*bm, D)
    ypt: torch.Tensor,          # (K, D) — Y^T, K a multiple of bk
    out: torch.Tensor,          # (nnz,) float32, written where core_lin >= 0
    bm: int,
    bk: int,
    tile_chunk: Optional[int] = None,
) -> torch.Tensor:
    """The SDDMM matrix path as the caller reads it: the tile stream of
    :func:`ref_tile_sddmm`, then ``out[i] = tiles.flat[core_lin[i]]`` for
    every ``i`` with ``core_lin[i] >= 0``; the other entries of ``out``
    are left as they are.  Returns ``out``."""
    tiles = ref_tile_sddmm(step_window, step_col, xp, ypt.t(), bm, bk,
                           tile_chunk=tile_chunk)
    sel = torch.nonzero(core_lin >= 0).squeeze(1)
    out[sel] = tiles.reshape(-1)[core_lin[sel]]
    return out


def ref_gather_sddmm(
    rows: torch.Tensor,  # (nnz,) int row ids into x
    cols: torch.Tensor,  # (nnz,) int row ids into yt
    pos: torch.Tensor,   # (nnz,) int positions in out
    x: torch.Tensor,     # (M, D)
    yt: torch.Tensor,    # (K, D) — Y pre-transposed
    out: torch.Tensor,   # (L,) float32, L > max(pos)
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """SDDMM vector path: ``out[pos[i]] = x[rows[i]] . yt[cols[i]]`` in
    fp32; the other entries of ``out`` are left as they are.  Returns
    ``out``.

    ``chunk`` bounds the materialized gathers to (chunk, D) per step; None
    is the one-shot form.
    """
    nnz = rows.shape[0]
    step = nnz if chunk is None or nnz <= chunk else int(chunk)
    for s in range(0, nnz, max(step, 1)):
        out[pos[s:s + step].long()] = (
            x[rows[s:s + step].long()].to(torch.float32)
            * yt[cols[s:s + step].long()].to(torch.float32)).sum(-1)
    return out
