"""Per-path dispatch: the matrix path and the vector path of the fused bodies.

``impl`` selection (``SpmmConfig.impl``):

- ``"cuda"``  — the hand-written Hopper kernels, on CUDA tensors;
- ``"torch"`` — the plain versions, on CPU tensors.  This follows the
  reference's ``"xla"`` branch, including its switch to one densified
  matmul above an occupancy threshold, so CPU results track
  ``impl="xla"`` of the JAX package.

Each function takes raw tensors (plan leaves arrive via the executor in
``repro_torch.exec``) and an optional ``derived`` dict in which index
arrays the kernels derive from leaves are cached for the plan's lifetime.
On a shard of a sharded plan ``derived`` also says how many entries of
each stream are the shard's own (``stack_padding``): on the card B1
leaves the padded tiles out of its window segments, and B2 and B3 walk
the padded fringe in a row order that keeps only the padding entries that
change the walk's sum.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.cost_model import select_sddmm_tier
from . import ref
from .dense_tile_spmm import dense_tile_spmm, window_chunks, window_segments
from .gather_spmm import (
    RowOrder, csr_indptr, drop_padding, gather_spmm, gather_spmm_ksharded,
    kbucket_row_order, sidecar_row_order, stream_row_order,
)
from .sddmm import dense_tile_sddmm, gather_sddmm, sampled_index
from .structured_spmm import bitmap_tile_spmm, nm_tile_spmm

IMPLS = ("cuda", "torch")

# the hand-written kernels' wrappers; each counts its launches in an integer
# attribute ``launches``, raised only where the kernel was launched
KERNELS = (dense_tile_spmm, gather_spmm, gather_spmm_ksharded,
           dense_tile_sddmm, gather_sddmm, nm_tile_spmm, bitmap_tile_spmm)

# occupancy (active tiles / total slots) above which the plain path
# switches from the streamed per-tile form to one densified matmul
DENSIFY_OCCUPANCY = 0.25


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


def effective_chunk(chunk: Optional[int]) -> int:
    """Nonzeros per chunk of the k-bucketed fringe stream.

    The reference's kernels unroll their chunk loop, so it clamps the
    value to 64, and plan builders pad the bucketed stream with this same
    value; the clamp is kept verbatim so the port's leaves match.
    """
    return min(chunk or 8, 64)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _cached(derived: Optional[Dict[str, Any]], key: str,
            make: Callable[[], Any]) -> Any:
    if derived is None:
        return make()
    if key not in derived:
        derived[key] = make()
    return derived[key]


def _own_entries(derived: Optional[Dict[str, Any]], key: str) -> Optional[int]:
    """How many leading entries of a stream are the shard's own, on a shard
    of a rows-sharded plan (``plan_ir.PlanShard``: the rest pads it to the
    mesh-uniform shape); None elsewhere."""
    pad = (derived or {}).get("stack_padding")
    return None if pad is None else pad[key]


def _padded_row_order(order: RowOrder, n_own: int) -> RowOrder:
    """``order`` with the padding past a shard's ``n_own`` entries (all in
    packed row 0) cut to the entries that change the walk's sum
    (``drop_padding``): the same bits as walking every one of them."""
    n = int(order.perm.shape[0])
    if n_own >= n:
        return order
    return drop_padding(order, np.arange(n) >= n_own)


def _check_impl(impl: str, b: torch.Tensor) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if (b.device.type == "cuda") != (impl == "cuda"):
        raise ValueError(
            f"impl={impl!r} does not run on a {b.device.type} tensor")


def block_stream_spmm(
    step_window: torch.Tensor,
    step_col: torch.Tensor,
    flat_values: torch.Tensor,
    b: torch.Tensor,
    *,
    num_windows: int,
    bm: int,
    bk: int,
    impl: str,
    derived: Optional[Dict[str, Any]] = None,
    a_flag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Matrix-engine path; returns packed (num_windows*bm, N) fp32.

    The tile stream must hold each (window, k-block) pair once, as
    ``prepare`` emits it: the plain densified form scatters tiles without
    summing duplicates.  ``a_flag`` is the plan's ``a_unsplittable`` (the
    kernels then skip computing it from the tile values).
    """
    if b.ndim != 2:
        raise ValueError(
            f"block_stream_spmm expects a rank-2 (K, N) operand, got shape "
            f"{tuple(b.shape)}")
    _check_impl(impl, b)
    if impl == "torch":
        t_steps = flat_values.shape[0]
        slots = max(num_windows * (b.shape[0] // bk), 1)
        core_elems = num_windows * bm * b.shape[0]
        if (num_windows and t_steps / slots >= DENSIFY_OCCUPANCY
                and core_elems <= 2 ** 26):
            return ref.densified_block_stream_spmm_unique(
                step_window, step_col, flat_values, b, num_windows)
        return ref.ref_block_stream_spmm(step_window, step_col, flat_values,
                                         b, num_windows)
    # a shard of a sharded plan walks its own tiles only: its padding
    # tiles (zeros, in the extra window, whose rows no gather reads) stay
    # out of the window segments
    own = _own_entries(derived, "steps")
    walked = step_window if own is None else step_window[:own]
    segments = _cached(derived, "window_segments",
                       lambda: window_segments(walked, num_windows))
    chunks = _cached(derived, "window_chunks",
                     lambda: window_chunks(segments[1]))
    return dense_tile_spmm(step_window, step_col, flat_values, b,
                           num_windows=num_windows, bm=bm, bk=bk,
                           segments=segments, chunks=chunks, a_flag=a_flag)


def nm_stream_spmm(
    step_window: torch.Tensor,
    step_col: torch.Tensor,
    nm_values: torch.Tensor,
    nm_codes: torch.Tensor,
    b: torch.Tensor,
    *,
    num_windows: int,
    bm: int,
    bk: int,
    n_pat: int,
    m_pat: int,
    impl: str,
    derived: Optional[Dict[str, Any]] = None,
    a_flag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Matrix-engine path over the N:M-packed tile stream; returns packed
    (num_windows*bm, N) fp32.  ``impl="torch"`` runs the reference's gather
    form (n/m of the dense-tile multiply-adds), ``impl="cuda"`` the kernel.
    """
    if b.ndim != 2:
        raise ValueError(
            f"nm_stream_spmm expects a rank-2 (K, N) operand, got shape "
            f"{tuple(b.shape)}")
    _check_impl(impl, b)
    if impl == "torch":
        return ref.ref_nm_stream_spmm(step_window, step_col, nm_values,
                                      nm_codes, b, num_windows, n_pat,
                                      m_pat, bk)
    segments = _cached(derived, "window_segments",
                       lambda: window_segments(step_window, num_windows))
    return nm_tile_spmm(step_window, step_col, nm_values, nm_codes, b,
                        num_windows=num_windows, bm=bm, bk=bk, n_pat=n_pat,
                        m_pat=m_pat, segments=segments, a_flag=a_flag)


def bitmap_stream_spmm(
    step_window: torch.Tensor,
    step_col: torch.Tensor,
    bitmap_words: torch.Tensor,
    bitmap_values: torch.Tensor,
    b: torch.Tensor,
    *,
    num_windows: int,
    bm: int,
    bk: int,
    row_cap: int,
    impl: str,
    derived: Optional[Dict[str, Any]] = None,
    a_flag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Matrix-engine path over the bitmap-packed tile stream; returns packed
    (num_windows*bm, N) fp32.  ``impl="torch"`` expands the tiles and runs
    the general streaming product, as the reference's ``"xla"`` impl does;
    ``impl="cuda"`` runs the kernel.
    """
    if b.ndim != 2:
        raise ValueError(
            f"bitmap_stream_spmm expects a rank-2 (K, N) operand, got shape "
            f"{tuple(b.shape)}")
    _check_impl(impl, b)
    if impl == "torch":
        return ref.ref_bitmap_stream_spmm(step_window, step_col,
                                          bitmap_words, bitmap_values, b,
                                          num_windows, bk)
    segments = _cached(derived, "window_segments",
                       lambda: window_segments(step_window, num_windows))
    return bitmap_tile_spmm(step_window, step_col, bitmap_words,
                            bitmap_values, b, num_windows=num_windows, bm=bm,
                            bk=bk, row_cap=row_cap, segments=segments,
                            a_flag=a_flag)


def fringe_spmm(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    b: torch.Tensor,
    *,
    num_rows: int,
    impl: str,
    chunk: Optional[int] = None,
    tier: str = "resident",
    bk: int = 0,
    kb_chunk: Optional[torch.Tensor] = None,
    kb_rows: Optional[torch.Tensor] = None,
    kb_cols: Optional[torch.Tensor] = None,
    kb_vals: Optional[torch.Tensor] = None,
    derived: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Vector-engine path; returns packed (num_rows, N) fp32.

    ``impl="torch"`` runs the reference gather on the packed fringe
    whatever the tier.  ``impl="cuda"`` runs the row-walk kernel: over the
    k-bucketed stream (remapped once to row-major order with global
    columns, cached in ``derived``) for tier "ksharded", over the packed
    fringe otherwise: a plan carried over from the JAX package may
    still say "xla", and on the card that means the row walk (the H100
    tier rule of ``core.cost_model.select_fringe_tier``).
    """
    if b.ndim != 2:
        raise ValueError(
            f"fringe_spmm expects a rank-2 (K, N) operand, got shape "
            f"{tuple(b.shape)}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be a positive nonzero count, got {chunk}")
    _check_impl(impl, b)
    if impl == "torch":
        return ref.ref_gather_spmm(rows, cols, vals, b, num_rows, chunk=chunk)
    if tier == "ksharded":
        if kb_rows is None or kb_chunk is None or bk <= 0:
            raise ValueError(
                "tier='ksharded' needs the k-bucketed stream (kb_chunk/"
                "kb_rows/kb_cols/kb_vals) and its bk")
        own = _own_entries(derived, "kb")
        order = _cached(derived, "kbucket_row_order",
                        lambda: _padded_row_order(kbucket_row_order(
                            kb_chunk, kb_rows, kb_cols, num_rows, bk),
                            kb_rows.shape[0] if own is None else own))
        return gather_spmm_ksharded(kb_chunk, kb_rows, kb_cols, kb_vals, b,
                                    num_rows=num_rows, bk=bk,
                                    row_order=order)
    own = _own_entries(derived, "fringe")
    if own is not None and own < rows.shape[0]:
        # a shard's padded fringe: (row 0, col 0, 0.0) entries follow its
        # own, so its rows are not sorted
        order = _cached(derived, "stack_row_order",
                        lambda: _padded_row_order(
                            stream_row_order(rows, cols, num_rows), own))
        return gather_spmm(rows, cols, vals, b, num_rows=num_rows,
                           row_order=order)
    indptr = _cached(derived, "csr_indptr",
                     lambda: csr_indptr(rows, num_rows))
    return gather_spmm(rows, cols, vals, b, num_rows=num_rows,
                       indptr=indptr)


def delta_fringe_spmm(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    b: torch.Tensor,
    *,
    num_rows: int,
    impl: str,
    chunk: Optional[int] = None,
    tier: str = "resident",
    bk: int = 0,
    kb_chunk: Optional[torch.Tensor] = None,
    kb_rows: Optional[torch.Tensor] = None,
    kb_cols: Optional[torch.Tensor] = None,
    kb_vals: Optional[torch.Tensor] = None,
    derived: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """A dynamic plan's delta sidecar through the fringe tiers; returns
    packed (num_rows, N) fp32.

    The sidecar (``plan_ir.DeltaFringe``) is a capacity-padded COO: its
    real entries sorted by key, then padding entries (row 0, col 0, 0.0),
    so its rows are not sorted.  ``impl="torch"`` runs the reference's
    gather on it.  ``impl="cuda"`` runs B3's walk over the k-bucketed
    sidecar for tier "ksharded", and B2's walk in the stream's stable row
    order (:func:`~repro_torch.kernels.gather_spmm.stream_row_order`)
    otherwise.  Every padding entry lies in packed row 0, so one warp would
    walk them all (up to ``capacity * chunk`` on the k-bucketed form).  The
    row order, cached in ``derived``, keeps only the few of them that
    change what the walk computes
    (:func:`~repro_torch.kernels.gather_spmm.drop_padding`): the result is
    bit for bit the walk over every padding entry, NaN where the padding
    reads an Inf or a NaN in B.  ``derived`` must be the sidecar's own
    cache (``DeltaFringe.derived``), never its plan's.
    """
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError(
            f"delta stream triplets disagree: rows={tuple(rows.shape)} "
            f"cols={tuple(cols.shape)} vals={tuple(vals.shape)}")
    if b.ndim != 2:
        raise ValueError(
            f"delta_fringe_spmm expects a rank-2 (K, N) operand, got shape "
            f"{tuple(b.shape)}")
    _check_impl(impl, b)
    if impl == "cuda" and tier == "ksharded":
        if kb_rows is None or kb_chunk is None or bk <= 0:
            raise ValueError(
                "tier='ksharded' needs the k-bucketed sidecar (kb_chunk/"
                "kb_rows/kb_cols/kb_vals) and its bk")
        order = _cached(derived, "kbucket_row_order",
                        lambda: sidecar_row_order(
                            rows, cols, num_rows, kb_chunk=kb_chunk,
                            kb_rows=kb_rows, kb_cols=kb_cols, bk=bk))
        return gather_spmm_ksharded(kb_chunk, kb_rows, kb_cols, kb_vals, b,
                                    num_rows=num_rows, bk=bk,
                                    row_order=order)
    if impl == "cuda":
        order = _cached(derived, "stream_row_order",
                        lambda: sidecar_row_order(rows, cols, num_rows))
        return gather_spmm(rows, cols, vals, b, num_rows=num_rows,
                           row_order=order)
    return fringe_spmm(rows, cols, vals, b, num_rows=num_rows, impl=impl,
                       chunk=chunk, tier=tier, bk=bk, kb_chunk=kb_chunk,
                       kb_rows=kb_rows, kb_cols=kb_cols, kb_vals=kb_vals,
                       derived=derived)


def sddmm_block_stream(
    step_window: torch.Tensor,
    step_col: torch.Tensor,
    core_lin: torch.Tensor,
    xp: torch.Tensor,
    ypt: torch.Tensor,
    out: torch.Tensor,
    *,
    bm: int,
    bk: int,
    impl: str,
    derived: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """SDDMM matrix path: writes the fp32 value of ``X @ Y`` at each core
    nonzero into ``out`` ((nnz,), input COO order) at its position
    (``core_lin >= 0``), and returns ``out``.

    ``xp`` is the window-gathered X row panel (num_windows*bm, D) and
    ``ypt`` Y^T with its rows permuted and padded as SpMM permutes and pads
    B's, (K, D).  The kernel's index arrays come from the structure alone
    and are cached in ``derived``.
    """
    _check_impl(impl, ypt)
    index = None
    if impl == "cuda":
        index = _cached(derived, "sddmm_sampled_index",
                        lambda: sampled_index(step_window, step_col, core_lin,
                                              bm=bm, bk=bk))
    return dense_tile_sddmm(step_window, step_col, core_lin, xp, ypt, out,
                            bm=bm, bk=bk, index=index)


def sddmm_gather(
    indptr: torch.Tensor,
    cols: torch.Tensor,
    pos: torch.Tensor,
    x: torch.Tensor,
    yt: torch.Tensor,
    out: torch.Tensor,
    *,
    impl: str,
    chunk: Optional[int] = None,
    vmem_budget: Optional[int] = None,
) -> torch.Tensor:
    """SDDMM vector path: writes ``x[r] . yt[cols[e]]`` into ``out`` at
    ``pos[e]`` for every entry ``e`` of the row walk ``indptr`` (a
    :class:`~repro_torch.core.plan_ir.FringeRowOrder`), and returns
    ``out``.

    ``yt`` is Y pre-transposed to (K, D) so both operands gather by row.
    ``impl="torch"`` runs the plain gather whatever the tier;
    ``impl="cuda"`` runs the row-walk kernel, the only tier the H100 rule
    of ``core.cost_model.select_sddmm_tier`` gives it.
    """
    if x.shape[-1] != yt.shape[-1]:
        raise ValueError(
            f"sddmm operands disagree on D: x {tuple(x.shape)} vs "
            f"y^T {tuple(yt.shape)}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be a positive nonzero count, got {chunk}")
    _check_impl(impl, x)
    if impl == "torch":
        rows = torch.repeat_interleave(
            torch.arange(x.shape[0], device=x.device),
            (indptr[1:] - indptr[:-1]).long())
        return ref.ref_gather_sddmm(rows, cols, pos, x, yt, out, chunk=chunk)
    tier = select_sddmm_tier(x.shape[-1], x.shape[0], yt.shape[0],
                             vmem_budget=vmem_budget, impl=impl)
    if tier != "resident":
        raise ValueError(f"no SDDMM gather kernel for tier {tier!r}")
    return gather_sddmm(indptr, cols, pos, x, yt, out)
