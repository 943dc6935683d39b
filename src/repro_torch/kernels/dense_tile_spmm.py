"""Matrix-engine ("AIC") path: flat-block-stream SpMM.

Port of ``repro.kernels.dense_tile_spmm`` (the Pallas TPU kernel).  The
dense core of A arrives as a stream of active (window, k-block) tiles;
``dense_tile_spmm`` returns the packed (num_windows*bm, N) fp32 product.

On a CUDA tensor the wrapper launches the hand-written Hopper kernels in
``csrc/dense_tile_spmm.cu`` (design notes there): the tile walk over
chunks of each window's segment (:func:`window_chunks`), beside it the
every-entry kernel that takes over where B holds an Inf or NaN or A or B a
value the 3xTF32 split cannot carry, then the
pass that sums a split window's partials; on a CPU tensor it runs the plain
version, :func:`repro_torch.kernels.ref.ref_block_stream_spmm`.  There is
no other path: a CUDA call launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.plan_ir import unsplittable_flag
from . import _build
from .ref import ref_block_stream_spmm

NAME = "dense_tile_spmm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I,
             _I, _P)

# the chunk table aims at this many chunks per SM (the kernel runs one
# block of a chunk per SM at a time, so several waves), and never cuts a
# chunk shorter than MIN_CHUNK_TILES tiles: a window that short is not
# split, and costs no partial
CHUNKS_PER_SM = 4
MIN_CHUNK_TILES = 64


# ints of scratch a matrix-path call hands its kernels for the check of its
# operands (tile_core::kFlagInts): one flag per block of the check of B,
# set where that block's share of B holds a value the 3xTF32 split cannot
# carry (an Inf, a NaN, |x| >= 3.401993e38), then A's flag; read on the
# device only
NONFINITE_FLAGS = 513


def nonfinite_flags(b: torch.Tensor) -> torch.Tensor:
    """Scratch for the check that every matrix-path call makes on the card
    before its tile kernel: where ``b`` or A holds an Inf or a NaN (or a
    value the split cannot carry) the kernels multiply every entry of every
    tile in fp32, as the TPU kernels' dense product does (0 * Inf = NaN)."""
    return torch.empty(NONFINITE_FLAGS, dtype=torch.int32, device=b.device)


def a_flag_of(values: torch.Tensor,
              a_flag: Optional[torch.Tensor]) -> torch.Tensor:
    """``a_flag`` where the caller has it (plans keep
    :func:`~repro_torch.core.plan_ir.unsplittable_flag` of their tile values
    as ``plan.a_unsplittable``), else computed from ``values`` (one read of
    them on the device)."""
    if a_flag is None:
        return unsplittable_flag(values)
    if (a_flag.dtype != torch.int32 or a_flag.numel() != 1
            or a_flag.device != values.device):
        raise ValueError(
            f"a_flag must be one int32 on {values.device}, got "
            f"{a_flag.dtype} {tuple(a_flag.shape)} on {a_flag.device}")
    return a_flag


def window_segments(
    step_window: torch.Tensor, num_windows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, seg)``: tile indices sorted by window (stable) and each
    window's segment ``[seg[w], seg[w+1])`` of ``order``, on the tensor's
    device.  The GPU's stand-in for the TPU grid's reset at each window
    change; tiles of one window are summed wherever they sit in the
    stream."""
    order = torch.argsort(step_window, stable=True).to(torch.int32)
    counts = torch.bincount(step_window.long(), minlength=num_windows)
    seg = torch.zeros(num_windows + 1, dtype=torch.int64,
                      device=step_window.device)
    seg[1:] = torch.cumsum(counts[:num_windows], 0)
    return order, seg.to(torch.int32)


class WindowChunks(NamedTuple):
    """Each window's segment cut into chunks of tiles, for the kernel.

    ``table`` (n_chunks, 4) int32: (window, first, end, slot) over the
    window-sorted ``order``, ordered by chunk position within its window,
    then window; ``slot`` is -1 for a window of one chunk (written straight
    to the output), else the chunk's partial slot.  ``reduce`` (n, 3)
    int32: (window, first slot, end slot) for every window the reduce pass
    writes: split windows (their slots in chunk order) and windows without
    tiles (no slots: zeros).  ``n_slots``: partials the call needs.
    """
    table: torch.Tensor
    reduce: torch.Tensor
    n_slots: int


def chunk_table(seg: np.ndarray, num_sms: int
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """:class:`WindowChunks`' arrays, in numpy, from the window segment
    offsets ``seg`` (num_windows+1,) and the card's SM count.  A
    deterministic function of its arguments."""
    seg = np.asarray(seg, np.int64)
    lengths = np.diff(seg)
    total = int(seg[-1]) if seg.size else 0
    chunk = max(MIN_CHUNK_TILES,
                -(-total // max(1, CHUNKS_PER_SM * num_sms)))
    n_chunk = -(-lengths // chunk)
    split = n_chunk > 1
    slots = np.where(split, n_chunk, 0)  # partial slots of each window
    slot_base = np.cumsum(slots) - slots
    win = np.repeat(np.arange(lengths.size), n_chunk)
    j = np.arange(win.size) - np.repeat(np.cumsum(n_chunk) - n_chunk,
                                        n_chunk)
    first = seg[win] + lengths[win] * j // n_chunk[win]
    end = seg[win] + lengths[win] * (j + 1) // n_chunk[win]
    slot = np.where(split[win], slot_base[win] + j, -1)
    by_position = np.lexsort((win, j))
    table = np.stack([win, first, end, slot], 1)[by_position]
    red_w = np.flatnonzero(split | (lengths == 0))
    reduce = np.stack([red_w, slot_base[red_w],
                       slot_base[red_w] + slots[red_w]], 1)
    n_slots = int(slots.sum())
    return (table.astype(np.int32).reshape(-1, 4),
            reduce.astype(np.int32).reshape(-1, 3), n_slots)


def window_chunks(seg: torch.Tensor,
                  num_sms: Optional[int] = None) -> WindowChunks:
    """:class:`WindowChunks` of the segments ``seg`` (from
    :func:`window_segments`), on ``seg``'s device.  ``num_sms`` defaults to
    the SM count of that device.  Reads ``seg`` on the host (one
    synchronisation): callers cache the result, as plans do in
    ``plan.derived``."""
    if num_sms is None:
        num_sms = torch.cuda.get_device_properties(
            seg.device).multi_processor_count
    table, reduce, n_slots = chunk_table(seg.cpu().numpy(), num_sms)
    return WindowChunks(torch.from_numpy(table).to(seg.device),
                        torch.from_numpy(reduce).to(seg.device), n_slots)


def _check(step_window, step_col, flat_values, b, num_windows, bm, bk):
    t = step_window.shape[0]
    if flat_values.shape != (t, bm, bk):
        raise ValueError(
            f"flat_values must be (T={t}, bm={bm}, bk={bk}), got "
            f"{tuple(flat_values.shape)}")
    if step_col.shape != (t,) or b.ndim != 2 or b.shape[0] % bk:
        raise ValueError(
            f"step_col must be (T,) and b (K, N) with K a multiple of "
            f"bk={bk}; got {tuple(step_col.shape)}, {tuple(b.shape)}")
    for name, x, dtype in (("step_window", step_window, torch.int32),
                           ("step_col", step_col, torch.int32),
                           ("flat_values", flat_values, torch.float32),
                           ("b", b, torch.float32)):
        if x.dtype != dtype or not x.is_contiguous() or x.device != b.device:
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor on {b.device}, "
                f"got {x.dtype} on {x.device}")


def dense_tile_spmm(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    flat_values: torch.Tensor,  # (T, bm, bk) float32
    b: torch.Tensor,            # (K, N) float32 — K a multiple of bk
    *,
    num_windows: int,
    bm: int,
    bk: int,
    segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    chunks: Optional[WindowChunks] = None,
    a_flag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed fp32 output (num_windows*bm, N).

    ``segments`` is :func:`window_segments` of ``step_window`` and
    ``chunks`` :func:`window_chunks` of its offsets, when the caller has
    them cached (plans keep both in ``plan.derived``); ``a_flag`` is
    :func:`~repro_torch.core.plan_ir.unsplittable_flag` of ``flat_values``
    (a plan's ``a_unsplittable``), computed here when not given.  One call is four
    kernel launches (the check of ``b``, the tile walk and the every-entry
    kernel, one of which returns at once, then the reduce pass), counted
    once in ``launches``.
    """
    if b.device.type == "cpu":
        return ref_block_stream_spmm(step_window, step_col, flat_values, b,
                                     num_windows)
    _check(step_window, step_col, flat_values, b, num_windows, bm, bk)
    fn = _build.function(NAME, "dense_tile_spmm_launch", _ARGTYPES)
    order, seg = segments or window_segments(step_window, num_windows)
    chunks = chunks or window_chunks(seg)
    n = b.shape[1]
    out = torch.empty((num_windows * bm, n), dtype=torch.float32,
                      device=b.device)
    partial = torch.empty((chunks.n_slots, bm, n), dtype=torch.float32,
                          device=b.device)
    flags = nonfinite_flags(b)
    a_flag = a_flag_of(flat_values, a_flag)
    status = fn(order.data_ptr(), step_col.data_ptr(),
                flat_values.data_ptr(), b.data_ptr(), b.shape[0],
                a_flag.data_ptr(), flags.data_ptr(), chunks.table.data_ptr(),
                chunks.table.shape[0],
                chunks.reduce.data_ptr(), chunks.reduce.shape[0],
                partial.data_ptr(), out.data_ptr(), bm, bk, n,
                torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_status(status, NAME)
    dense_tile_spmm.launches += 1
    return out


dense_tile_spmm.launches = 0  # kernel launches (CPU calls do not count)
