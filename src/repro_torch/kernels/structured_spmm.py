"""Matrix-engine path over packed tile streams: the structured lane.

Port of ``repro.kernels.structured_spmm`` (the two Pallas TPU kernels).
The dense core of A arrives as the same stream of active (window, k-block)
tiles as for :func:`~repro_torch.kernels.dense_tile_spmm.dense_tile_spmm`,
with each tile packed (``repro_torch.core.formats``):

- :func:`nm_tile_spmm` — N:M slots: slot-major values (T, bm, n*gk) and
  int32 position codes (T, bm, gk), 8 bits per slot;
- :func:`bitmap_tile_spmm` — occupancy words (T, bm, ceil(bk/32)) and each
  row's nonzeros packed in column order (T, bm, row_cap).

Both return the packed (num_windows*bm, N) fp32 product.  On CUDA tensors
the wrappers launch the hand-written Hopper kernels in
``csrc/structured_spmm.cu`` (design notes there): the N:M kernel decodes
each tile for a tensor-core product where n/m is dense enough and walks
the packed slots otherwise; the bitmap kernel chooses per tile on the
device, decoding dense tiles for the tensor cores and walking the set bits
of sparse ones.  On CPU tensors they run the plain versions,
:func:`~repro_torch.kernels.ref.ref_nm_stream_spmm_dense` and
:func:`~repro_torch.kernels.ref.ref_bitmap_stream_spmm`.  A CUDA call
launches its kernel or raises.

Where B holds an Inf or NaN, or A or B a value the 3xTF32 split cannot
carry, the kernels multiply every tile entry, as the TPU kernels' dense
product does (see :func:`~repro_torch.kernels.dense_tile_spmm.
nonfinite_flags`), and so do both plain versions.  The ``"torch"``
impl runs :func:`~repro_torch.kernels.ref.ref_nm_stream_spmm` instead, the
reference's gather form (its ``"xla"`` oracle), which multiplies only the
packed slots: with finite B the two agree within fp32 rounding.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .dense_tile_spmm import a_flag_of, nonfinite_flags, window_segments
from .ref import ref_bitmap_stream_spmm, ref_nm_stream_spmm_dense

NAME = "structured_spmm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES_NM = (_P,) * 6 + (_I, _P, _P, _P) + (_I,) * 6 + (_P,)
_ARGTYPES_BITMAP = (_P,) * 6 + (_I, _P, _P, _P) + (_I,) * 5 + (_P,)
# the N:M kernel stages a whole tile as one slice of the tile core
# (tile_core::kSlice)
NM_MAX_BK = 64


def _check(device: torch.device, shapes, **tensors) -> None:
    """Raise unless each tensor is contiguous, on ``device``, of its dtype
    and of the shape ``shapes`` gives for its name."""
    for name, (x, dtype) in tensors.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(
                f"{name} must have shape {shapes[name]}, got "
                f"{tuple(x.shape)}")
        if x.dtype != dtype or not x.is_contiguous() or x.device != device:
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor on {device}, "
                f"got {x.dtype} on {x.device}")


def _stream(b: torch.Tensor) -> int:
    return torch.cuda.current_stream(b.device).cuda_stream


def nm_tile_spmm(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    nm_values: torch.Tensor,    # (T, bm, n*gk) float32, slot-major
    nm_codes: torch.Tensor,     # (T, bm, gk) int32 position codes
    b: torch.Tensor,            # (K, N) float32 — K a multiple of bk
    *,
    num_windows: int,
    bm: int,
    bk: int,
    n_pat: int,
    m_pat: int,
    segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    a_flag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed fp32 output (num_windows*bm, N) of the N:M tile stream.

    ``segments`` is :func:`window_segments` of ``step_window``, when the
    caller has it cached (plans keep it in ``plan.derived``); ``a_flag``
    as for :func:`~repro_torch.kernels.dense_tile_spmm.dense_tile_spmm`
    (computed here from ``nm_values`` when not given).
    """
    if b.device.type == "cpu":
        return ref_nm_stream_spmm_dense(step_window, step_col, nm_values,
                                        nm_codes, b, num_windows, n_pat,
                                        m_pat, bk)
    if (not 1 <= n_pat <= 4 or m_pat <= 0 or bk % m_pat or bk > NM_MAX_BK
            or b.ndim != 2 or b.shape[0] % bk):
        raise ValueError(
            f"N:M kernel needs 1 <= n <= 4, m dividing bk, bk <= "
            f"{NM_MAX_BK} and b (K, N) with K a multiple of bk; got "
            f"n={n_pat}, m={m_pat}, bk={bk}, b {tuple(b.shape)}")
    t = step_window.shape[0]
    gk = bk // m_pat
    _check(b.device, {"step_window": (t,), "step_col": (t,),
                      "nm_values": (t, bm, n_pat * gk),
                      "nm_codes": (t, bm, gk), "b": tuple(b.shape)},
           step_window=(step_window, torch.int32),
           step_col=(step_col, torch.int32),
           nm_values=(nm_values, torch.float32),
           nm_codes=(nm_codes, torch.int32), b=(b, torch.float32))
    order, seg = segments or window_segments(step_window, num_windows)
    n = b.shape[1]
    out = torch.empty((num_windows * bm, n), dtype=torch.float32,
                      device=b.device)
    fn = _build.function(NAME, "nm_tile_spmm_launch", _ARGTYPES_NM)
    flags = nonfinite_flags(b)
    a_flag = a_flag_of(nm_values, a_flag)
    status = fn(order.data_ptr(), seg.data_ptr(), step_col.data_ptr(),
                nm_values.data_ptr(), nm_codes.data_ptr(), b.data_ptr(),
                b.shape[0], a_flag.data_ptr(), flags.data_ptr(),
                out.data_ptr(), num_windows,
                bm, bk, n, n_pat, m_pat, _stream(b))
    _build.check_status(status, "nm_tile_spmm")
    nm_tile_spmm.launches += 1
    return out


def bitmap_tile_spmm(
    step_window: torch.Tensor,    # (T,) int32
    step_col: torch.Tensor,       # (T,) int32
    bitmap_words: torch.Tensor,   # (T, bm, ceil(bk/32)) int32
    bitmap_values: torch.Tensor,  # (T, bm, row_cap) float32
    b: torch.Tensor,              # (K, N) float32 — K a multiple of bk
    *,
    num_windows: int,
    bm: int,
    bk: int,
    row_cap: int,
    segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    a_flag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed fp32 output (num_windows*bm, N) of the bitmap tile stream;
    ``segments`` and ``a_flag`` as for :func:`nm_tile_spmm` (``a_flag``
    computed here from ``bitmap_values`` when not given)."""
    if b.device.type == "cpu":
        return ref_bitmap_stream_spmm(step_window, step_col, bitmap_words,
                                      bitmap_values, b, num_windows, bk)
    if row_cap < 1 or b.ndim != 2 or b.shape[0] % bk:
        raise ValueError(
            f"bitmap kernel needs row_cap >= 1 and b (K, N) with K a "
            f"multiple of bk; got row_cap={row_cap}, bk={bk}, b "
            f"{tuple(b.shape)}")
    t = step_window.shape[0]
    _check(b.device, {"step_window": (t,), "step_col": (t,),
                      "bitmap_words": (t, bm, (bk + 31) // 32),
                      "bitmap_values": (t, bm, row_cap), "b": tuple(b.shape)},
           step_window=(step_window, torch.int32),
           step_col=(step_col, torch.int32),
           bitmap_words=(bitmap_words, torch.int32),
           bitmap_values=(bitmap_values, torch.float32),
           b=(b, torch.float32))
    order, seg = segments or window_segments(step_window, num_windows)
    n = b.shape[1]
    out = torch.empty((num_windows * bm, n), dtype=torch.float32,
                      device=b.device)
    fn = _build.function(NAME, "bitmap_tile_spmm_launch", _ARGTYPES_BITMAP)
    flags = nonfinite_flags(b)
    a_flag = a_flag_of(bitmap_values, a_flag)
    status = fn(order.data_ptr(), seg.data_ptr(), step_col.data_ptr(),
                bitmap_words.data_ptr(), bitmap_values.data_ptr(),
                b.data_ptr(), b.shape[0], a_flag.data_ptr(), flags.data_ptr(),
                out.data_ptr(),
                num_windows, bm, bk, n, row_cap, _stream(b))
    _build.check_status(status, "bitmap_tile_spmm")
    bitmap_tile_spmm.launches += 1
    return out


nm_tile_spmm.launches = 0      # kernel launches (CPU calls do not count)
bitmap_tile_spmm.launches = 0
