"""Hierarchical tile reuse (paper §6.2), adapted to the TPU memory hierarchy.

Intra-core (§6.2.2) — tile-shape selection.  The paper derives
(M, N, K) = (128, 256, 64) on Ascend from double-buffered L0A/L0B/L0C
capacities, MXU utilization, input traffic, and 512-byte write-back
alignment.  We re-derive the same trade on TPU constants:

  - operands and output live in VMEM (~16 MB/core, shared, double-buffered
    by the Pallas pipeline, so a tile set may claim <= VMEM_BUDGET/2);
  - MXU is a 128x128 systolic array: bm, bn want to be multiples of 128,
    bk a multiple of 8 (sublane) with diminishing returns past 128;
  - write-back prefers bn a multiple of the 128-lane register width
    (TPU's analogue of the 512 B FixPipe transaction).

Inter-core (§6.2.1) — schedule-induced residency.  Ascend pins hot B rows
in shared L2; TPU has no software-pinnable shared cache, but the Pallas
grid pipeline *elides the HBM->VMEM copy when consecutive grid steps map to
the same block*.  Ordering windows cluster-major therefore keeps each hot
B block resident across all windows of a cluster — the same reuse objective
expressed through schedule order instead of cache control.  The planner
also enforces the paper's working-set bound (<= 80% of a capacity budget)
by splitting oversized clusters.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .arrays import sorted_unique
from .cost_model import MXU_DIM, SUBLANES, VMEM_BYTES, VPU_LANES


@dataclasses.dataclass(frozen=True)
class TileShape:
    bm: int
    bn: int
    bk: int

    @property
    def volume(self) -> int:
        return self.bm * self.bn * self.bk

    def vmem_bytes(self, in_dtype_bytes: int = 2, acc_dtype_bytes: int = 4) -> int:
        a = self.bm * self.bk * in_dtype_bytes
        b = self.bk * self.bn * in_dtype_bytes
        c = self.bm * self.bn * acc_dtype_bytes
        return a + b + c

    def input_traffic(self, in_dtype_bytes: int = 2) -> int:
        """Per-tile HBM->VMEM bytes (the paper's 2(MK+NK) criterion)."""
        return (self.bm * self.bk + self.bk * self.bn) * in_dtype_bytes


def select_tile_shape(
    n_cols: int,
    vmem_budget: int = VMEM_BYTES // 2,  # double buffering halves the claim
    in_dtype_bytes: int = 2,
    acc_dtype_bytes: int = 4,
    bm_candidates: Tuple[int, ...] = (128, 256, 512),
    bn_candidates: Tuple[int, ...] = (128, 256, 512, 1024),
    bk_candidates: Tuple[int, ...] = (32, 64, 128, 256),
) -> TileShape:
    """Re-derive the paper's (M,N,K) trade for TPU.

    Objective ordering mirrors §6.2.2: (1) respect capacity, (2) maximize
    MXU-aligned tile volume (throughput), (3) among ties minimize input
    traffic per unit volume, (4) prefer lane-aligned bn.
    """
    best: Optional[TileShape] = None
    best_key = None
    for bm in bm_candidates:
        if bm % MXU_DIM:
            continue
        for bn in bn_candidates:
            if bn % VPU_LANES or bn > max(n_cols, VPU_LANES):
                continue
            for bk in bk_candidates:
                if bk % SUBLANES:
                    continue
                t = TileShape(bm, bn, bk)
                if t.vmem_bytes(in_dtype_bytes, acc_dtype_bytes) > vmem_budget:
                    continue
                # effective MXU throughput saturates once bk >= 128
                eff = min(bk, MXU_DIM) / MXU_DIM
                key = (
                    t.volume * eff,                      # maximize
                    -t.input_traffic(in_dtype_bytes) / t.volume,  # then minimize traffic/vol
                    bn % 128 == 0,
                )
                if best_key is None or key > best_key:
                    best, best_key = t, key
    assert best is not None, "no feasible tile shape"
    return best


@dataclasses.dataclass
class ReusePlan:
    """Grid-order plan for the matrix path."""

    window_order: np.ndarray       # permutation of window ids (cluster-major)
    est_b_blocks_loaded: int       # B-block loads after copy elision
    est_b_blocks_naive: int        # B-block loads with no reuse ordering
    working_set_blocks: int        # max distinct B blocks touched by a cluster

    @property
    def reuse_factor(self) -> float:
        return self.est_b_blocks_naive / max(self.est_b_blocks_loaded, 1)


def _capacity_boundaries(
    oc: np.ndarray,
    entry_window: np.ndarray,
    entry_starts: np.ndarray,
    blocks_flat: np.ndarray,
    cap: int,
) -> np.ndarray:
    """Segment boundaries under a distinct-B working-set bound.

    Greedy maximal segments: each boundary starts where extending the
    current segment by one more window would push its distinct-block count
    past ``cap`` (or the cluster changes).  Loops once per *segment* —
    within one, the distinct-count scan is a vectorized first-occurrence
    cumsum, so the cost is O(segments * segment-entries), not
    O(windows * blocks) of interpreted set algebra.
    """
    nw = oc.shape[0]
    cluster_bounds = np.flatnonzero(
        np.concatenate([[True], oc[1:] != oc[:-1]])
    ).tolist() + [nw]
    boundaries = []
    for ci in range(len(cluster_bounds) - 1):
        cs, ce = cluster_bounds[ci], cluster_bounds[ci + 1]
        start = cs
        while start < ce:
            boundaries.append(start)
            lo, hi = entry_starts[start], entry_starts[ce]
            seg_blocks = blocks_flat[lo:hi]
            if seg_blocks.size == 0:  # all-empty windows: one segment
                break
            # distinct-count after each window of the candidate segment
            first = np.zeros(seg_blocks.size, np.int64)
            first[np.unique(seg_blocks, return_index=True)[1]] = 1
            cum = np.cumsum(first)
            # count at window w = cum at that window's last entry (windows
            # with no entries inherit the previous count)
            ends = entry_starts[start + 1:ce + 1] - lo
            counts = np.concatenate([[0], cum])[ends]
            fits = np.flatnonzero(counts <= cap)
            # always include the segment's first window, even alone > cap
            nxt = start + (int(fits[-1]) + 1 if fits.size else 1)
            start = max(nxt, start + 1)
    return np.asarray(sorted(set(boundaries)), np.int64)


def plan_window_order(
    block_cols: np.ndarray,
    num_blocks: np.ndarray,
    cluster_of_window: np.ndarray,
    capacity_blocks: Optional[int] = None,
    capacity_frac: float = 0.8,
) -> ReusePlan:
    """Order windows cluster-major, then by leading block id, to maximize
    consecutive same-B-block grid steps (copy elision).

    ``capacity_blocks`` bounds the distinct-B working set per cluster
    (paper: <=80% of L2); clusters exceeding it are split into chunks.

    Runs as numpy segment ops end to end — no per-window python sets.  The
    old interpreted scan was O(windows * blocks) on every ``prepare``,
    which the dynamic-delta compaction path now re-enters repeatedly.
    """
    nw = block_cols.shape[0]
    if nw == 0:
        return ReusePlan(np.zeros(0, np.int64), 0, 0, 0)
    num_blocks = np.asarray(num_blocks, np.int64)
    cluster_of_window = np.asarray(cluster_of_window)
    lead = np.where(num_blocks > 0, block_cols[:, 0], -1)
    order = np.lexsort((lead, cluster_of_window))

    # flatten every window's block list in scan order: entry e belongs to
    # scan position entry_window[e] and names B block blocks_flat[e]
    oc = cluster_of_window[order]
    ob_counts = num_blocks[order]
    total = int(ob_counts.sum())
    entry_starts = np.concatenate([[0], np.cumsum(ob_counts)])
    entry_window = np.repeat(np.arange(nw), ob_counts)
    col_idx = np.arange(total) - np.repeat(
        entry_starts[:-1], ob_counts
    )
    blocks_flat = block_cols[order[entry_window], col_idx]

    # segment the scan order: cluster boundaries, plus capacity splits
    if capacity_blocks is not None:
        cap = max(1, int(capacity_blocks * capacity_frac))
        boundaries = _capacity_boundaries(
            oc, entry_window, entry_starts, blocks_flat, cap
        )
    else:
        boundaries = np.flatnonzero(
            np.concatenate([[True], oc[1:] != oc[:-1]])
        )
    is_boundary = np.zeros(nw, bool)
    is_boundary[boundaries] = True

    # copy elision: window i's leading block load is elided iff it equals
    # the previous window's lead (−1 for an empty window — never matches)
    # and i does not start a segment
    ol = lead[order]
    prev_lead = np.concatenate([[-1], ol[:-1]])
    elided = int(np.count_nonzero(
        (~is_boundary) & (ob_counts > 0) & (ol == prev_lead)
    ))
    naive = int(num_blocks.sum())
    loaded = naive - elided

    # working set: max distinct blocks touched by any segment — unique
    # (segment, block) pairs bucket-counted per segment
    ws = 0
    if total:
        seg_of_pos = np.cumsum(is_boundary) - 1
        seg_of_entry = seg_of_pos[entry_window]
        span = int(blocks_flat.max()) + 1
        pairs = sorted_unique(seg_of_entry * span + blocks_flat)
        ws = int(np.bincount(pairs // span).max())
    return ReusePlan(
        window_order=order.astype(np.int64),
        est_b_blocks_loaded=loaded,
        est_b_blocks_naive=naive,
        working_set_blocks=ws,
    )
