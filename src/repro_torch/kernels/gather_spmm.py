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
order, then walks.  On CPU tensors they run the plain versions from
:mod:`repro_torch.kernels.ref`.  A CUDA call launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

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


class KBucketRowOrder(NamedTuple):
    """The k-bucketed stream in row-major order, from its structure alone.

    ``perm`` (nnz,) int32: a stable row-major order of the stream (each
    row's entries stay in k-block order, padding entries included, in row
    0); ``indptr`` (num_rows+1,) int32: row offsets into it; ``cols``
    (nnz,) int32: the global column ``chunk_kb[i // chunk] * bk + col`` of
    entry ``perm[j]`` at position j.  The values are not here: a value
    update rewrites them, so each call gathers ``vals[perm]`` first.
    """
    perm: torch.Tensor
    indptr: torch.Tensor
    cols: torch.Tensor


def kbucket_row_order(
    chunk_kb: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    num_rows: int, bk: int,
) -> KBucketRowOrder:
    """:class:`KBucketRowOrder` of a k-bucketed stream, on its device
    (one host read: plans cache it in ``plan.derived``)."""
    perm = torch.argsort(rows, stable=True)
    chunk = rows.shape[0] // max(chunk_kb.shape[0], 1)
    gcols = (torch.repeat_interleave(chunk_kb, chunk) * bk + cols)[perm]
    return KBucketRowOrder(perm.to(torch.int32),
                           csr_indptr(rows[perm], num_rows),
                           gcols.to(torch.int32).contiguous())


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
) -> torch.Tensor:
    """Resident tier.  ``chunk`` only bounds the plain version's gather;
    ``indptr`` is :func:`csr_indptr` of ``rows`` when the caller has it
    cached (plans keep it in ``plan.derived``)."""
    if b.device.type == "cpu":
        return ref_gather_spmm(rows, cols, vals, b, num_rows, chunk=chunk)
    _check(b, rows=(rows, torch.int32), cols=(cols, torch.int32),
           vals=(vals, torch.float32))
    if indptr is None:
        indptr = csr_indptr(rows, num_rows)
    n = b.shape[1]
    out = torch.empty((num_rows, n), dtype=torch.float32, device=b.device)
    fn = _build.function(NAME, "gather_spmm_launch", _ARGTYPES)
    status = fn(indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                b.data_ptr(), out.data_ptr(), num_rows, n, _stream(b))
    _build.check_status(status, NAME)
    gather_spmm.launches += 1
    return out


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
    row_order: Optional[KBucketRowOrder] = None,
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
    n = b.shape[1]
    out = torch.empty((num_rows, n), dtype=torch.float32, device=b.device)
    scratch = torch.empty_like(vals)
    fn = _build.function(NAME, "gather_spmm_perm_launch", _ARGTYPES_PERM)
    status = fn(order.indptr.data_ptr(), order.cols.data_ptr(),
                order.perm.data_ptr(), vals.data_ptr(), scratch.data_ptr(),
                vals.shape[0], b.data_ptr(), out.data_ptr(), num_rows, n,
                _stream(b))
    _build.check_status(status, NAME_KSHARDED)
    gather_spmm_ksharded.launches += 1
    return out


gather_spmm_ksharded.launches = 0  # kernel launches (CPU calls do not count)
