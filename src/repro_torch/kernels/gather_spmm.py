"""Vector-engine ("AIV") path: row-sorted COO gather SpMM, two tiers.

Port of ``repro.kernels.gather_spmm`` (the two Pallas TPU fringe kernels):

- :func:`gather_spmm` — tier "resident": ``out[rows[i]] += vals[i] *
  B[cols[i]]`` over the row-sorted packed fringe COO;
- :func:`gather_spmm_ksharded` — tier "ksharded": the same product over the
  k-bucketed stream built by ``plan_ir.bucket_fringe_kblocks`` (columns
  local to the k-block ``chunk_kb`` names for their chunk).

Both return the packed (num_rows, N) fp32 output.  On CUDA tensors the
wrappers launch the hand-written Hopper kernel in ``csrc/gather_spmm.cu``
(design notes there), the row walk: the k-bucketed stream is remapped once,
from its structure alone, into a row-major order with global columns
(:func:`kbucket_row_order`), and each call gathers its values into that
order, then walks.  A packed stream whose rows are not sorted (the delta
sidecar of a dynamic plan, padded to its capacity with (row 0, col 0, 0.0)
entries) gets the same treatment in :func:`gather_spmm` with a
``row_order``; a sidecar's (:func:`sidecar_row_order`) keeps only the
padding entries that change the walk's sum (:func:`drop_padding`).  On CPU tensors they run the
plain versions from :mod:`repro_torch.kernels.ref`.  A CUDA call launches
its kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .ref import ref_gather_spmm, ref_gather_spmm_kblocked

NAME = "gather_spmm"
NAME_KSHARDED = "gather_spmm_ksharded"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _P)
_ARGTYPES_PERM = (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P)


def csr_indptr(sorted_rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """(num_rows+1,) int32 row offsets of a row-sorted stream, on its
    device.  Raises if the rows are not sorted (one device sync)."""
    if sorted_rows.numel() > 1 and not bool(
            (sorted_rows[1:] >= sorted_rows[:-1]).all()):
        raise ValueError("gather_spmm needs row-sorted nonzeros")
    counts = torch.bincount(sorted_rows.long(), minlength=num_rows)
    indptr = torch.zeros(num_rows + 1, dtype=torch.int64,
                         device=sorted_rows.device)
    indptr[1:] = torch.cumsum(counts[:num_rows], 0)
    return indptr.to(torch.int32)


# the shares of B's rows whose nonzeros fringe_profile reports (hottest
# first), and the row length above which it counts a row as long
HOT_ROW_SHARES = (0.001, 0.01, 0.10)
LONG_ROW = 1024


def fringe_profile(indptr: torch.Tensor, cols: torch.Tensor,
                   num_b_rows: int) -> dict:
    """What bounds the row walk on one packed fringe, from its row offsets
    ``indptr`` and columns ``cols`` (B rows ``[0, num_b_rows)``), on their
    device: the row lengths (``max``, ``p50``, ``p99``, linear quantiles as
    numpy's) and the share of nonzeros in rows longer than ``LONG_ROW``;
    the share of nonzeros whose column is among the hottest
    ``HOT_ROW_SHARES`` of B's rows (``ceil(share * num_b_rows)`` rows, by
    nonzero count).  Plain floats (one host read)."""
    lengths = (indptr[1:] - indptr[:-1]).to(torch.float64)
    nnz = max(int(cols.numel()), 1)
    qs = (torch.quantile(lengths, torch.tensor([0.5, 0.99], device=
                                               lengths.device,
                                               dtype=torch.float64)).tolist()
          if lengths.numel() else [0.0, 0.0])
    freq = torch.sort(torch.bincount(cols.long(), minlength=num_b_rows),
                      descending=True).values
    top = torch.cumsum(freq, 0)
    hot = {}
    for share in HOT_ROW_SHARES:
        count = min(max(1, math.ceil(round(share * num_b_rows, 6))),
                    top.numel())
        hot[f"{share:g}"] = (float(top[count - 1]) / nnz if top.numel()
                             else 0.0)
    return {
        "rows": int(lengths.numel()), "nnz": int(cols.numel()),
        "max": float(lengths.max()) if lengths.numel() else 0.0,
        "p50": qs[0], "p99": qs[1],
        "long_share": float(lengths[lengths > LONG_ROW].sum()) / nnz,
        "hot_share": hot,
    }


class RowOrder(NamedTuple):
    """A packed stream in row-major order, from its structure alone.

    ``perm`` (nnz,) int32: a stable row-major order of the stream (each
    row's entries stay in stream order, padding entries included, in row
    0); ``indptr`` (num_rows+1,) int32: row offsets into it; ``cols``
    (nnz,) int32: the global column of entry ``perm[j]`` at position j (for
    a k-bucketed stream ``chunk_kb[i // chunk] * bk + col``).  The values
    are not here: a value update rewrites them, so each call gathers
    ``vals[perm]`` first.
    """
    perm: torch.Tensor
    indptr: torch.Tensor
    cols: torch.Tensor


def stream_row_order(rows: torch.Tensor, cols: torch.Tensor,
                     num_rows: int) -> RowOrder:
    """:class:`RowOrder` of a packed stream whose rows need not be sorted
    (``cols`` global), on its device (one host read: callers cache it)."""
    perm = torch.argsort(rows, stable=True)
    return RowOrder(perm.to(torch.int32), csr_indptr(rows[perm], num_rows),
                    cols[perm].to(torch.int32).contiguous())


def kbucket_row_order(
    chunk_kb: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    num_rows: int, bk: int,
) -> RowOrder:
    """:class:`RowOrder` of a k-bucketed stream, on its device (one host
    read: plans cache it in ``plan.derived``)."""
    chunk = rows.shape[0] // max(chunk_kb.shape[0], 1)
    gcols = torch.repeat_interleave(chunk_kb, chunk) * bk + cols
    return stream_row_order(rows, gcols, num_rows)


# How the walk (csrc/gather_spmm.cu, kDefaultSlice = 64 columns and
# kDefaultUnroll = 4) sums a row: the entry at position p of the row goes
# to partial sum p % WALK_GROUPS, each partial sum takes its entries in
# row order, and the walk takes WALK_STEP entries a step, adding 0 * 0 in
# the slots of the row's last step that lie past its end.  The partial
# sums are added at the end.  tests/test_torch_ksharded.py reads both
# numbers from the source.
WALK_GROUPS = 2
WALK_STEP = 8


def sidecar_real_count(rows: torch.Tensor, cols: torch.Tensor) -> int:
    """Real entries of a delta sidecar's packed stream
    (``plan_ir.DeltaFringe``): they come first, sorted by strictly rising
    (row, column) keys, and the capacity padding (row 0, col 0, 0.0)
    follows, so the first key that does not rise starts the padding (one
    host read)."""
    r = rows.cpu().numpy().astype(np.int64)
    c = cols.cpu().numpy().astype(np.int64)
    if r.size < 2:
        return int(r.size)
    key = r * (int(c.max()) + 1) + c
    fall = np.flatnonzero(key[1:] <= key[:-1])
    return int(fall[0]) + 1 if fall.size else int(r.size)


def kbucket_padding(chunk_kb: torch.Tensor, n_entries: int,
                    real_cols: torch.Tensor, bk: int) -> np.ndarray:
    """(n_entries,) bool: the padding entries of a sidecar's k-bucketed
    stream (``plan_ir.bucket_fringe_kblocks`` of the packed stream, padded
    to its capacity).  ``real_cols`` are the packed stream's real columns:
    each k-block's bucket starts with its real entries, in packed order,
    and everything else (the packed stream's capacity padding, bucketed
    into k-block 0, each bucket's fill to a whole chunk, and the trailing
    chunks) is padding."""
    kbc = chunk_kb.cpu().numpy().astype(np.int64)
    chunk = n_entries // max(kbc.size, 1)
    kb = real_cols.cpu().numpy().astype(np.int64) // bk
    pad = np.ones(n_entries, bool)
    if not kb.size:
        return pad
    # the bucketed chunks rise by k-block; the trailing ones restart at 0
    fall = np.flatnonzero(kbc[1:] < kbc[:-1])
    n_bucketed = int(fall[0]) + 1 if fall.size else kbc.size
    counts = np.bincount(kb)
    blocks = np.flatnonzero(counts)
    starts = np.searchsorted(kbc[:n_bucketed], blocks) * chunk
    n = counts[blocks]
    first = np.cumsum(n) - n
    pos = np.repeat(starts - first, n) + np.arange(int(n.sum()))
    pad[pos] = False
    return pad


def _kept_padding(pos0: int, cols: np.ndarray, last: bool) -> np.ndarray:
    """Indices (into one run of padding entries at row position ``pos0``,
    global columns ``cols``) of the entries to walk in place of the whole
    run, with the same effect on the row's sum.

    A padding entry adds ``0 * B[col]``: nothing to a partial sum that is
    not zero, NaN where B[col] is an Inf or a NaN, and to a zero it gives
    +0 unless the zero is -0 and B[col] negative.  So a run acts on each
    partial sum through the set of columns among its entries there, each
    once.  A run followed by a real entry keeps that set for every partial
    sum; the ``last`` run of the row only needs each column once, since
    the partial sums are then added (a sum of zeros is -0 only if every
    term is).  The kept run's length is the run's modulo ``WALK_STEP``, so
    every later entry keeps its partial sum and the row's last step its
    slots past the end."""
    size = cols.size
    if last:
        first = np.sort(np.unique(cols, return_index=True)[1])
        kept = first.size + (size - first.size) % WALK_STEP
        return np.concatenate([first, np.full(kept - first.size, first[0])])
    group = (pos0 + np.arange(size)) % WALK_GROUPS
    key = group * (int(cols.max()) + 1) + cols
    first = np.sort(np.unique(key, return_index=True)[1])
    sets = [first[group[first] == g] for g in range(WALK_GROUPS)]
    need = max(s.size for s in sets) * WALK_GROUPS
    kept = need + (size - need) % WALK_STEP
    if kept >= size or any(s.size == 0 for s in sets):
        return np.arange(size)
    slot = np.arange(kept)
    out = np.empty(kept, np.int64)
    for g in range(WALK_GROUPS):
        mine = (pos0 + slot) % WALK_GROUPS == g
        rank = np.minimum(slot[mine] // WALK_GROUPS, sets[g].size - 1)
        out[mine] = sets[g][rank]
    return out


def drop_padding(order: RowOrder, is_pad: np.ndarray) -> RowOrder:
    """``order`` with the padding entries (``is_pad`` over stream
    positions, all in row 0) cut to those that change what the walk
    computes: each run of them between two real entries of row 0, or after
    the last, becomes :func:`_kept_padding` of it, at most a few entries.
    The walk over the result is bit for bit the walk over ``order``,
    non-finite values and signed zeros in B included (one host read)."""
    end0 = int(order.indptr[1])
    perm = order.perm.cpu().numpy().astype(np.int64)
    pad = np.asarray(is_pad, bool)[perm]
    if pad[end0:].any():
        raise ValueError("drop_padding: padding entries outside row 0")
    cols0 = order.cols[:end0].cpu().numpy()
    edges = np.diff(np.concatenate([[0], pad[:end0].astype(np.int8), [0]]))
    starts = np.flatnonzero(edges == 1)
    ends = np.flatnonzero(edges == -1)
    keep, prev = [], 0
    for s, e in zip(starts, ends):
        keep.append(np.arange(prev, s))
        keep.append(s + _kept_padding(int(s), cols0[s:e], e == end0))
        prev = e
    keep.append(np.arange(prev, end0))
    keep = torch.from_numpy(np.concatenate(keep)).to(order.perm.device)
    cut = end0 - int(keep.numel())
    indptr = order.indptr.clone()
    indptr[1:] -= cut
    return RowOrder(torch.cat([order.perm[keep], order.perm[end0:]]),
                    indptr,
                    torch.cat([order.cols[keep], order.cols[end0:]]))


def sidecar_row_order(
    rows: torch.Tensor, cols: torch.Tensor, num_rows: int, *,
    kb_chunk: Optional[torch.Tensor] = None,
    kb_rows: Optional[torch.Tensor] = None,
    kb_cols: Optional[torch.Tensor] = None, bk: int = 0,
) -> RowOrder:
    """The row order B2 walks a delta sidecar's packed stream in (``rows``,
    ``cols``), or with ``kb_*`` and ``bk`` the order B3 walks its
    k-bucketed copy in, each with its padding cut by
    :func:`drop_padding` (host reads: callers cache it in the sidecar's
    ``derived``)."""
    n_real = sidecar_real_count(rows, cols)
    if kb_chunk is None:
        return drop_padding(stream_row_order(rows, cols, num_rows),
                            np.arange(rows.shape[0]) >= n_real)
    return drop_padding(
        kbucket_row_order(kb_chunk, kb_rows, kb_cols, num_rows, bk),
        kbucket_padding(kb_chunk, kb_rows.shape[0], cols[:n_real], bk))


def _check(b: torch.Tensor, **tensors) -> None:
    if b.ndim != 2 or b.dtype != torch.float32 or not b.is_contiguous():
        raise ValueError(
            f"b must be a contiguous float32 (K, N) tensor, got "
            f"{b.dtype} {tuple(b.shape)}")
    for name, (x, dtype) in tensors.items():
        if x.dtype != dtype or not x.is_contiguous() or x.device != b.device:
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor on {b.device}, "
                f"got {x.dtype} on {x.device}")


def _stream(b: torch.Tensor) -> int:
    return torch.cuda.current_stream(b.device).cuda_stream


def gather_spmm(
    rows: torch.Tensor,  # (nnz,) int32, row-sorted packed row ids
    cols: torch.Tensor,  # (nnz,) int32
    vals: torch.Tensor,  # (nnz,) float32
    b: torch.Tensor,     # (K, N) float32
    *,
    num_rows: int,
    chunk: Optional[int] = None,
    indptr: Optional[torch.Tensor] = None,
    row_order: Optional[RowOrder] = None,
) -> torch.Tensor:
    """Resident tier.  ``chunk`` only bounds the plain version's gather;
    ``indptr`` is :func:`csr_indptr` of ``rows`` when the caller has it
    cached (plans keep it in ``plan.derived``).

    ``row_order`` (:func:`stream_row_order` of ``rows`` and ``cols``, or
    a sidecar's :func:`sidecar_row_order`) walks a stream whose rows are
    not sorted, such as a delta sidecar padded with (row 0, col 0, 0.0)
    entries: on the card that is two launches, counted once, the gather
    of the values into the row order, then the walk.  A padding entry
    adds ``0 * B[0]`` to packed row 0, as in the plain version: NaN where
    B's row 0 holds an Inf or a NaN."""
    if b.device.type == "cpu":
        return ref_gather_spmm(rows, cols, vals, b, num_rows, chunk=chunk)
    _check(b, rows=(rows, torch.int32), cols=(cols, torch.int32),
           vals=(vals, torch.float32))
    n = b.shape[1]
    out = torch.empty((num_rows, n), dtype=torch.float32, device=b.device)
    if row_order is not None:
        _walk_in_order(row_order, vals, b, out, num_rows, NAME)
    else:
        if indptr is None:
            indptr = csr_indptr(rows, num_rows)
        fn = _build.function(NAME, "gather_spmm_launch", _ARGTYPES)
        status = fn(indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                    b.data_ptr(), out.data_ptr(), num_rows, n, _stream(b))
        _build.check_status(status, NAME)
    gather_spmm.launches += 1
    return out


def _walk_in_order(order: RowOrder, vals: torch.Tensor, b: torch.Tensor,
                   out: torch.Tensor, num_rows: int, name: str) -> None:
    """The walk over ``vals`` gathered into ``order``: two launches.  The
    order may walk fewer entries than the stream holds (a sidecar's cut
    padding), or some more than once."""
    walked = order.perm.shape[0]
    scratch = torch.empty(walked, dtype=vals.dtype, device=vals.device)
    fn = _build.function(NAME, "gather_spmm_perm_launch", _ARGTYPES_PERM)
    status = fn(order.indptr.data_ptr(), order.cols.data_ptr(),
                order.perm.data_ptr(), vals.data_ptr(), scratch.data_ptr(),
                walked, b.data_ptr(), out.data_ptr(), num_rows,
                b.shape[1], _stream(b))
    _build.check_status(status, name)


gather_spmm.launches = 0  # kernel launches (CPU calls do not count)


def gather_spmm_ksharded(
    chunk_kb: torch.Tensor,  # (num_chunks,) int32, chunk -> k-block id
    rows: torch.Tensor,  # (num_chunks*chunk,) int32 k-bucketed packed rows
    cols: torch.Tensor,  # (num_chunks*chunk,) int32 k-block-LOCAL columns
    vals: torch.Tensor,  # (num_chunks*chunk,) float32, 0 on padding entries
    b: torch.Tensor,     # (K, N) float32
    *,
    num_rows: int,
    bk: int,
    row_order: Optional[RowOrder] = None,
) -> torch.Tensor:
    """K-sharded streaming tier.  ``row_order`` is
    :func:`kbucket_row_order` of the stream when the caller has it cached.

    On the card it is two launches, counted once: the gather of the
    values into the row-major order, then the walk of :func:`gather_spmm`.
    B is read as it is, K rows: every global column of the stream, padding
    entries' included (``chunk_kb * bk``, the first column of a k-block
    that holds a real entry), is below K.  A padding entry adds ``0 *
    B[chunk_kb * bk]``, as the TPU kernel does: NaN where that row of B
    holds an Inf or a NaN."""
    num_chunks = chunk_kb.shape[0]
    if num_chunks < 1 or rows.shape[0] % num_chunks:
        raise ValueError(
            f"bucketed stream of {rows.shape[0]} entries does not split into "
            f"{num_chunks} chunks")
    if b.device.type == "cpu":
        return ref_gather_spmm_kblocked(chunk_kb, rows, cols, vals, b,
                                        num_rows, bk)
    _check(b, chunk_kb=(chunk_kb, torch.int32), rows=(rows, torch.int32),
           cols=(cols, torch.int32), vals=(vals, torch.float32))
    order = row_order or kbucket_row_order(chunk_kb, rows, cols, num_rows,
                                           bk)
    out = torch.empty((num_rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    _walk_in_order(order, vals, b, out, num_rows, NAME_KSHARDED)
    gather_spmm_ksharded.launches += 1
    return out


gather_spmm_ksharded.launches = 0  # kernel launches (CPU calls do not count)
