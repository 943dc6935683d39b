"""SDDMM kernels: (X @ Y) sampled at a plan's nonzeros, on both paths.

Port of ``repro.kernels.sddmm`` (the two Pallas TPU kernels):

- :func:`dense_tile_sddmm` — matrix path: for each active (window, k-block)
  tile of the plan's stream, ``tiles[t] = Xp[w[t]*bm : +bm] @ Yp[:,
  c[t]*bk : +bk]``, the fp32 stream (T, bm, bk); the caller extracts
  per-nonzero values at the plan's ``core_lin`` slots;
- :func:`gather_sddmm` — vector path: ``out[i] = X[rows[i]] . Yt[cols[i]]``
  for every fringe nonzero, in input order.

On CUDA tensors the wrappers launch the hand-written Hopper kernels in
``csrc/sddmm.cu`` (design notes there); on CPU tensors they run the plain
versions from :mod:`repro_torch.kernels.ref`.  A CUDA call launches its
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ref_gather_sddmm, ref_tile_sddmm

NAME = "sddmm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES_TILE = (_P, _P, _P, _P, _P, _L, _I, _I, _I, _L, _P)
_ARGTYPES_GATHER = (_P, _P, _P, _P, _P, _L, _I, _I, _P)


def _check(device: torch.device, **tensors) -> None:
    for name, (x, dtype) in tensors.items():
        if x.dtype != dtype or not x.is_contiguous() or x.device != device:
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor on {device}, "
                f"got {x.dtype} on {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def dense_tile_sddmm(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    xp: torch.Tensor,           # (num_windows*bm, D) float32
    yp: torch.Tensor,           # (D, K) float32 — K a multiple of bk
    *,
    bm: int,
    bk: int,
) -> torch.Tensor:
    """The fp32 dense-product tile stream (T, bm, bk)."""
    if (xp.shape[0] % bm or yp.shape[1] % bk or xp.shape[1] != yp.shape[0]
            or step_col.shape != step_window.shape):
        raise ValueError(
            f"xp must be (num_windows*{bm}, D), yp (D, K) with K a multiple "
            f"of {bk}, and step_window and step_col (T,); got "
            f"{tuple(xp.shape)}, {tuple(yp.shape)}, "
            f"{tuple(step_window.shape)}, {tuple(step_col.shape)}")
    if xp.device.type == "cpu":
        return ref_tile_sddmm(step_window, step_col, xp, yp, bm, bk)
    _check(xp.device, step_window=(step_window, torch.int32),
           step_col=(step_col, torch.int32), xp=(xp, torch.float32),
           yp=(yp, torch.float32))
    t = step_window.shape[0]
    d, k = yp.shape
    out = torch.empty((t, bm, bk), dtype=torch.float32, device=xp.device)
    fn = _build.function(NAME, "dense_tile_sddmm_launch", _ARGTYPES_TILE)
    status = fn(step_window.data_ptr(), step_col.data_ptr(), xp.data_ptr(),
                yp.data_ptr(), out.data_ptr(), t, bm, bk, d, k, _stream(xp))
    _build.check_status(status, "dense_tile_sddmm")
    dense_tile_sddmm.launches += 1
    return out


dense_tile_sddmm.launches = 0  # kernel launches (CPU calls do not count)


def gather_sddmm(
    rows: torch.Tensor,  # (nnz,) int32 row ids into x
    cols: torch.Tensor,  # (nnz,) int32 row ids into yt
    x: torch.Tensor,     # (M, D) float32
    yt: torch.Tensor,    # (K, D) float32 — Y pre-transposed
) -> torch.Tensor:
    """fp32 dots (nnz,) in input order."""
    if (x.ndim != 2 or yt.ndim != 2 or x.shape[1] != yt.shape[1]
            or rows.ndim != 1 or cols.shape != rows.shape):
        raise ValueError(
            f"gather_sddmm operands must be (M, D) and (K, D) and the index "
            f"arrays (nnz,) each; got {tuple(x.shape)}, {tuple(yt.shape)}, "
            f"{tuple(rows.shape)}, {tuple(cols.shape)}")
    if x.device.type == "cpu":
        return ref_gather_sddmm(rows, cols, x, yt)
    _check(x.device, rows=(rows, torch.int32), cols=(cols, torch.int32),
           x=(x, torch.float32), yt=(yt, torch.float32))
    nnz = rows.shape[0]
    d = x.shape[1]
    vec4 = d % 4 == 0 and x.data_ptr() % 16 == 0 and yt.data_ptr() % 16 == 0
    out = torch.empty(nnz, dtype=torch.float32, device=x.device)
    fn = _build.function(NAME, "gather_sddmm_launch", _ARGTYPES_GATHER)
    status = fn(rows.data_ptr(), cols.data_ptr(), x.data_ptr(),
                yt.data_ptr(), out.data_ptr(), nnz, d, int(vec4),
                _stream(x))
    _build.check_status(status, "gather_sddmm")
    gather_sddmm.launches += 1
    return out


gather_sddmm.launches = 0  # kernel launches (CPU calls do not count)
