"""SDDMM kernels: (X @ Y) sampled at a plan's nonzeros, on both paths.

Port of ``repro.kernels.sddmm`` (the two Pallas TPU kernels):

- :func:`dense_tile_sddmm` — matrix path: the fp32 values of ``X @ Y`` at
  the plan's core slots.  The TPU kernel returns the whole tile stream
  ``tiles[t] = Xp[w[t]*bm : +bm] @ Yp[:, c[t]*bk : +bk]`` (T, bm, bk), of
  which the caller reads the slots ``core_lin``; the port's function keeps
  its name but returns what the caller reads, written at each core
  nonzero's position, and the card's kernel never builds the stream (a
  cell depends on its own row of X and column of Y only, so the values
  are the same, Inf and NaN included);
- :func:`gather_sddmm` — vector path: ``X[r] . Yt[c]`` for every fringe
  nonzero ``(r, c)``.  The TPU kernel returns the dots in input order; the
  port's walks the fringe in row order (``core.plan_ir.fringe_row_order``,
  from the structure alone) and writes each dot at its final position in
  the SDDMM output, so the caller gathers nothing afterwards.

On CUDA tensors the wrappers launch the hand-written Hopper kernels in
``csrc/sddmm.cu`` (design notes there); on CPU tensors they run the plain
versions from :mod:`repro_torch.kernels.ref`.  A CUDA call launches its
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .ref import ref_gather_sddmm, ref_tile_sddmm_at_slots

NAME = "sddmm"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES_TILE = (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)
# core nonzeros one block of the sampled kernel takes at most: a k-block
# with more is cut into segments of this many (each stages the k-block's
# Y^T rows again), so that no block sets the call's tail
SEG_NNZ = 8192
_ARGTYPES_GATHER = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P)
# the row walk's column slice (kSliceCols in csrc/sddmm.cu): a D wider than
# this takes several passes, whose sums wait in a scratch
SLICE_COLS = 32


def _check(device: torch.device, **tensors) -> None:
    for name, (x, dtype) in tensors.items():
        if x.dtype != dtype or not x.is_contiguous() or x.device != device:
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor on {device}, "
                f"got {x.dtype} on {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


class SampledIndex(NamedTuple):
    """The core nonzeros as the sampled kernel walks them, from the
    structure alone (plans cache it in ``plan.derived``).

    Ordered by k-block, then by tile slot; per nonzero (int32): ``x_row``,
    its row in the window-gathered X panel (``step_window[t]*bm + r``);
    ``y_row``, its row in the permuted, padded Y^T (``step_col[t]*bk +
    c``); ``pos``, its position in the SDDMM output.  ``seg_kb`` and
    ``seg_ptr`` (int32): segment s holds entries ``[seg_ptr[s],
    seg_ptr[s+1])``, all of k-block ``seg_kb[s]``, at most ``SEG_NNZ``.
    """
    x_row: torch.Tensor
    y_row: torch.Tensor
    pos: torch.Tensor
    seg_kb: torch.Tensor
    seg_ptr: torch.Tensor


def sampled_index(step_window: torch.Tensor, step_col: torch.Tensor,
                  core_lin: torch.Tensor, *, bm: int, bk: int,
                  seg_nnz: int = SEG_NNZ) -> SampledIndex:
    """:class:`SampledIndex` of a plan's core slots ``core_lin`` ((nnz,)
    int64 flat slot ``t*bm*bk + r*bk + c`` of the tile stream, -1 off the
    core), on their device.  Reads its sizes on the host (one
    synchronisation)."""
    if core_lin.numel() >= 2 ** 31:
        raise ValueError(f"{core_lin.numel()} nonzeros do not fit int32")
    dev = core_lin.device
    pos = torch.nonzero(core_lin >= 0).squeeze(1)
    slot = core_lin[pos]
    tile = slot // (bm * bk)
    within = slot % (bm * bk)
    kb = step_col.long()[tile]
    order = torch.argsort(kb * max(1, step_col.numel() * bm * bk) + slot,
                          stable=True)
    pos, tile, within, kb = pos[order], tile[order], within[order], kb[order]
    x_row = step_window.long()[tile] * bm + within // bk
    y_row = kb * bk + within % bk
    nkb = int(kb.max()) + 1 if kb.numel() else 0
    counts = torch.bincount(kb, minlength=nkb)
    start = torch.cumsum(counts, 0) - counts
    n_seg = (counts + seg_nnz - 1) // seg_nnz
    seg_kb = torch.repeat_interleave(torch.arange(nkb, device=dev), n_seg)
    first = torch.cumsum(n_seg, 0) - n_seg
    j = (torch.arange(seg_kb.numel(), device=dev)
         - torch.repeat_interleave(first, n_seg))
    seg_ptr = torch.cat([start[seg_kb] + j * seg_nnz,
                         torch.tensor([pos.numel()], device=dev)])

    def i32(x):
        return x.to(torch.int32).contiguous()

    return SampledIndex(i32(x_row), i32(y_row), i32(pos), i32(seg_kb),
                        i32(seg_ptr))


def dense_tile_sddmm(
    step_window: torch.Tensor,  # (T,) int32
    step_col: torch.Tensor,     # (T,) int32
    core_lin: torch.Tensor,     # (nnz,) int64 flat tile slot, -1 elsewhere
    xp: torch.Tensor,           # (num_windows*bm, D) float32
    ypt: torch.Tensor,          # (K, D) float32 — Y^T, K a multiple of bk
    out: Optional[torch.Tensor] = None,  # (nnz,) float32
    *,
    bm: int,
    bk: int,
    index: Optional[SampledIndex] = None,
) -> torch.Tensor:
    """The fp32 values of ``X @ Y`` at the plan's core slots: ``out[i] =
    tiles.flat[core_lin[i]]`` for every ``i`` with ``core_lin[i] >= 0``,
    where ``tiles[t] = xp[step_window[t]*bm : +bm] @ ypt[step_col[t]*bk :
    +bk].T``; the other entries of ``out`` are left as they are.  ``out``
    defaults to zeros.  Returns ``out``.

    ``index`` is :func:`sampled_index` of the structure when the caller has
    it cached (plans keep it in ``plan.derived``).
    """
    if (xp.ndim != 2 or ypt.ndim != 2 or xp.shape[0] % bm
            or ypt.shape[0] % bk or xp.shape[1] != ypt.shape[1]
            or step_col.shape != step_window.shape or core_lin.ndim != 1):
        raise ValueError(
            f"xp must be (num_windows*{bm}, D), ypt (K, D) with K a multiple "
            f"of {bk}, step_window and step_col (T,) and core_lin (nnz,); "
            f"got {tuple(xp.shape)}, {tuple(ypt.shape)}, "
            f"{tuple(step_window.shape)}, {tuple(step_col.shape)}, "
            f"{tuple(core_lin.shape)}")
    if out is None:
        out = torch.zeros(core_lin.shape[0], dtype=torch.float32,
                          device=xp.device)
    if out.shape != core_lin.shape or out.dtype != torch.float32:
        raise ValueError(
            f"out must be float32 {tuple(core_lin.shape)}, got {out.dtype} "
            f"{tuple(out.shape)}")
    if xp.device.type == "cpu":
        return ref_tile_sddmm_at_slots(step_window, step_col, core_lin, xp,
                                       ypt, out, bm, bk)
    _check(xp.device, step_window=(step_window, torch.int32),
           step_col=(step_col, torch.int32), core_lin=(core_lin, torch.int64),
           xp=(xp, torch.float32), ypt=(ypt, torch.float32),
           out=(out, torch.float32))
    if index is None:
        index = sampled_index(step_window, step_col, core_lin, bm=bm, bk=bk)
    n_seg = index.seg_kb.shape[0]
    if n_seg == 0:
        return out
    d = xp.shape[1]
    if d == 0:  # empty dots
        return out.index_fill_(0, index.pos.long(), 0.0)
    vec4 = d % 4 == 0 and xp.data_ptr() % 16 == 0 and ypt.data_ptr() % 16 == 0
    fn = _build.function(NAME, "dense_tile_sddmm_launch", _ARGTYPES_TILE)
    status = fn(index.seg_kb.data_ptr(), index.seg_ptr.data_ptr(), n_seg,
                index.x_row.data_ptr(), index.y_row.data_ptr(),
                index.pos.data_ptr(), xp.data_ptr(), ypt.data_ptr(),
                out.data_ptr(), bk, d, int(vec4), _stream(xp))
    _build.check_status(status, "dense_tile_sddmm")
    dense_tile_sddmm.launches += 1
    return out


dense_tile_sddmm.launches = 0  # kernel launches (CPU calls do not count)


def _check_gather(indptr, cols, pos, x, yt, out) -> None:
    if (x.ndim != 2 or yt.ndim != 2 or x.shape[1] != yt.shape[1]
            or indptr.ndim != 1 or indptr.shape[0] != x.shape[0] + 1
            or cols.ndim != 1 or pos.shape != cols.shape
            or out.ndim != 1 or out.dtype != torch.float32):
        raise ValueError(
            f"gather_sddmm operands must be x (M, D), yt (K, D), indptr "
            f"(M+1,), the index arrays (nnz,) each and out float32 (L,); "
            f"got {tuple(x.shape)}, {tuple(yt.shape)}, "
            f"{tuple(indptr.shape)}, {tuple(cols.shape)}, "
            f"{tuple(pos.shape)}, {out.dtype} {tuple(out.shape)}")


def gather_sddmm(
    indptr: torch.Tensor,  # (M+1,) int32 row offsets of the walk
    cols: torch.Tensor,    # (nnz,) int32 row ids into yt, in row order
    pos: torch.Tensor,     # (nnz,) int32 positions in out
    x: torch.Tensor,       # (M, D) float32
    yt: torch.Tensor,      # (K, D) float32 — Y pre-transposed
    out: torch.Tensor,     # (L,) float32
) -> torch.Tensor:
    """``out[pos[e]] = x[r] . yt[cols[e]]`` for every entry ``e`` of row
    ``r`` (``indptr[r] <= e < indptr[r+1]``), fp32; the other entries of
    ``out`` are left as they are.  Returns ``out``.

    The index is ``core.plan_ir.fringe_row_order``'s layout.  On the
    card: the row walk of ``csrc/sddmm.cu``, one launch per
    ``SLICE_COLS`` columns of D, in order: the first starts each dot, each
    later one adds its part, so two calls are bit-identical.  Between the
    launches the sums live in a scratch of one float per entry, in the
    walk's order.  The launches count once.
    """
    _check_gather(indptr, cols, pos, x, yt, out)
    if x.device.type == "cpu":
        rows = torch.repeat_interleave(
            torch.arange(x.shape[0]), (indptr[1:] - indptr[:-1]).long())
        return ref_gather_sddmm(rows, cols, pos, x, yt, out)
    _check(x.device, indptr=(indptr, torch.int32), cols=(cols, torch.int32),
           pos=(pos, torch.int32), x=(x, torch.float32),
           yt=(yt, torch.float32), out=(out, torch.float32))
    if cols.numel() == 0:
        return out
    d = x.shape[1]
    if d == 0:  # empty dots
        return out.index_fill_(0, pos.long(), 0.0)
    acc = torch.empty(cols.shape[0] if d > SLICE_COLS else 1,
                      dtype=torch.float32, device=x.device)
    fn = _build.function(NAME, "gather_sddmm_launch", _ARGTYPES_GATHER)
    status = fn(indptr.data_ptr(), cols.data_ptr(), pos.data_ptr(),
                x.data_ptr(), yt.data_ptr(), out.data_ptr(), acc.data_ptr(),
                x.shape[0], d, _stream(x))
    _build.check_status(status, "gather_sddmm")
    gather_sddmm.launches += 1
    return out


gather_sddmm.launches = 0  # kernel launches (CPU calls do not count)
