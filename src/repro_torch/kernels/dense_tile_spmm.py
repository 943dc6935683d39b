"""Matrix-engine ("AIC") path: flat-block-stream SpMM.

Port of ``repro.kernels.dense_tile_spmm`` (the Pallas TPU kernel).  The
dense core of A arrives as a stream of active (window, k-block) tiles;
``dense_tile_spmm`` returns the packed (num_windows*bm, N) fp32 product.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/dense_tile_spmm.cu`` (design notes there); on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.ref_block_stream_spmm`.
There is no other path: a CUDA call launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import ref_block_stream_spmm

NAME = "dense_tile_spmm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)


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
) -> torch.Tensor:
    """Packed fp32 output (num_windows*bm, N).

    ``segments`` is :func:`window_segments` of ``step_window``, when the
    caller has it cached (plans keep it in ``plan.derived``).
    """
    if b.device.type == "cpu":
        return ref_block_stream_spmm(step_window, step_col, flat_values, b,
                                     num_windows)
    _check(step_window, step_col, flat_values, b, num_windows, bm, bk)
    order, seg = segments or window_segments(step_window, num_windows)
    n = b.shape[1]
    out = torch.empty((num_windows * bm, n), dtype=torch.float32,
                      device=b.device)
    fn = _build.function(NAME, "dense_tile_spmm_launch", _ARGTYPES)
    status = fn(order.data_ptr(), seg.data_ptr(), step_col.data_ptr(),
                flat_values.data_ptr(), b.data_ptr(), out.data_ptr(),
                num_windows, bm, bk, n,
                torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_status(status, NAME)
    dense_tile_spmm.launches += 1
    return out


dense_tile_spmm.launches = 0  # kernel launches (CPU calls do not count)
