"""Global-local tile reordering (paper §6.1), host-side preprocessing.

Global stage — coarse row+column clustering.  The paper uses Rabbit Order
(community detection on the bipartite nnz graph) with a deliberately small
cluster count.  We implement the O(nnz)-per-pass *barycenter heuristic*:
alternating row/column sorts by mean neighbor position, which recovers
block-community structure in a handful of passes — the same "few large
clusters, cheap to compute" trade the paper makes, without the out-of-repo
Rabbit dependency.  (A MinHash signature utility is kept for the local
stage's large-cluster fallback.)

Local stage — within each cluster, rows are regrouped into ``bm``-row
windows so that rows in a window share column blocks (anchor + most-similar
fill via Jaccard over column-block sets, the paper's exact rule).  For
clusters too large for the quadratic greedy, a signature sort gives the same
adjacency effect in O(n log n).  Only rows permute; global column order is
preserved (paper: "much cheaper than full element-level reordering").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .arrays import sorted_unique


@dataclasses.dataclass
class ReorderResult:
    row_order: np.ndarray      # packed order of (core) rows: row_order[i] = orig row at slot i
    col_order: np.ndarray      # permutation of columns (identity if disabled)
    cluster_of_row: np.ndarray # cluster id per packed slot
    n_clusters: int


def _minhash_signatures(
    item_of_nnz: np.ndarray, other_of_nnz: np.ndarray, n_items: int, n_hashes: int, seed: int
) -> np.ndarray:
    """MinHash of each item's set of 'other' ids.  (n_items, n_hashes) uint64."""
    rng = np.random.RandomState(seed)
    muls = rng.randint(1, 2**31 - 1, size=n_hashes).astype(np.uint64) * np.uint64(2) + np.uint64(1)
    adds = rng.randint(0, 2**31 - 1, size=n_hashes).astype(np.uint64)
    sig = np.full((n_items, n_hashes), np.iinfo(np.uint64).max, np.uint64)
    vals = other_of_nnz.astype(np.uint64)
    for h in range(n_hashes):
        hv = vals * muls[h] + adds[h]
        np.minimum.at(sig[:, h], item_of_nnz, hv)
    return sig


def global_reorder(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    n_iters: int = 4,
    max_clusters: int = 64,
    reorder_cols: bool = True,
    seed: int = 0,
    min_cluster_rows: int = 512,
) -> ReorderResult:
    """Coarse row+column co-clustering via the barycenter heuristic.

    Alternating passes sort rows by the mean position of their columns and
    vice versa — O(nnz) per pass, recovering block-community structure in a
    handful of iterations (the paper's "few large clusters, cheap to
    compute" trade; Rabbit Order plays this role on Ascend).  Rows without
    nonzeros sink to the tail.  Cluster labels are contiguous segments of
    the final order (bounded by ``max_clusters``) consumed by the reuse
    planner.
    """
    m, k = shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)

    if rows.size == 0:
        return ReorderResult(
            row_order=np.arange(m, dtype=np.int64),
            col_order=np.arange(k, dtype=np.int64),
            cluster_of_row=np.zeros(m, np.int64),
            n_clusters=1,
        )

    row_cnt = np.bincount(rows, minlength=m).astype(np.float64)
    col_cnt = np.bincount(cols, minlength=k).astype(np.float64)
    row_pos = np.arange(m, dtype=np.float64)
    col_pos = np.arange(k, dtype=np.float64)
    has_r = row_cnt > 0
    has_c = col_cnt > 0

    for it in range(n_iters):
        # rows <- mean position of their columns
        acc = np.bincount(rows, weights=col_pos[cols], minlength=m)
        key = np.where(has_r, acc / np.maximum(row_cnt, 1), np.inf)
        order_r = np.argsort(key, kind="stable")
        row_pos[order_r] = np.arange(m, dtype=np.float64)
        if not reorder_cols and it > 0:
            continue
        # cols <- mean position of their rows
        accc = np.bincount(cols, weights=row_pos[rows], minlength=k)
        ckey = np.where(has_c, accc / np.maximum(col_cnt, 1), np.inf)
        order_c = np.argsort(ckey, kind="stable")
        col_pos[order_c] = np.arange(k, dtype=np.float64)

    row_order = np.argsort(row_pos, kind="stable")
    col_order = (np.argsort(col_pos, kind="stable") if reorder_cols
                 else np.arange(k, dtype=np.int64))

    # contiguous segments of the final order = clusters (bounded count);
    # clusters must span several row-windows or the local stage has no room
    n_clusters = max(1, min(max_clusters, m // min_cluster_rows or 1))
    seg = max(1, -(-m // n_clusters))
    cluster_of_row = np.arange(m, dtype=np.int64) // seg
    return ReorderResult(
        row_order=row_order,
        col_order=col_order,
        cluster_of_row=cluster_of_row,
        n_clusters=int(cluster_of_row.max()) + 1,
    )


def _jaccard_greedy_windows(
    row_ids: np.ndarray, block_mask: np.ndarray, bm: int
) -> np.ndarray:
    """Paper's exact local rule: pick an anchor, fill the window with the
    (bm-1) most Jaccard-similar unassigned rows.

    ``block_mask`` is the (n, n_kblocks) 0/1 membership matrix; all pairwise
    intersections come from one integer-exact matmul, so the loop body is a
    similarity lookup + stable top-k instead of O(n) python set algebra.
    """
    n = len(row_ids)
    x = block_mask.astype(np.float64)
    inter = x @ x.T  # exact: block counts are small integers
    sizes = x.sum(axis=1)
    alive = np.ones(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    nxt = 0  # first-alive pointer (rows are consumed in ascending order)
    while pos < n:
        while not alive[nxt]:
            nxt += 1
        anchor = nxt
        alive[anchor] = False
        order[pos] = anchor
        pos += 1
        cand = np.flatnonzero(alive)  # ascending == original relative order
        if cand.size == 0:
            break
        inter_a = inter[anchor, cand]
        union = sizes[anchor] + sizes[cand] - inter_a
        sims = np.where(union > 0, inter_a / np.maximum(union, 1e-9), 0.0)
        take = np.argsort(-sims, kind="stable")[: bm - 1]
        chosen = cand[take]  # similarity-ranked inside the window
        order[pos : pos + chosen.size] = chosen
        pos += chosen.size
        alive[chosen] = False
    return row_ids[order]


def local_reorder(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    global_res: ReorderResult,
    bm: int,
    bk: int,
    exact_limit: int = 512,
) -> np.ndarray:
    """Refine the packed row order inside each cluster into bm-row windows.
    Fully deterministic (greedy similarity ranking; no randomness).

    Returns a new full row order (length m).  Rows with similar column-block
    sets land in the same window, so BlockELL packing compacts more empty
    blocks away.
    """
    m, k = shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    inv_col = np.empty(k, np.int64)
    inv_col[global_res.col_order] = np.arange(k)
    kblk = inv_col[cols] // bk  # column-block ids AFTER the global col permutation
    n_kblocks = (k + bk - 1) // bk

    # deduplicate (row, block) pairs once, globally (sorted, first-occurrence
    # mask) — replaces a per-row np.unique call per cluster.  A single
    # fused-key sort stands in for the 2-key lexsort (no permutation needed,
    # only the sorted pairs).
    keys_sorted = np.sort(rows * np.int64(n_kblocks) + kblk)
    r_sorted = keys_sorted // n_kblocks
    b_sorted = keys_sorted % n_kblocks
    if r_sorted.size:
        keep = np.concatenate(
            [[True],
             (r_sorted[1:] != r_sorted[:-1]) | (b_sorted[1:] != b_sorted[:-1])]
        )
        ur, ub = r_sorted[keep], b_sorted[keep]
    else:
        ur = ub = r_sorted
    # CSR-style row pointers over the unique pairs
    row_ptr = np.searchsorted(ur, np.arange(m + 1))
    deg = np.diff(row_ptr)

    new_order = np.empty(m, np.int64)
    pos = 0
    cluster_ids = global_res.cluster_of_row
    packed = global_res.row_order
    boundaries = np.flatnonzero(np.diff(cluster_ids)) + 1
    segments = np.split(np.arange(m), boundaries)

    for seg in segments:
        cluster_rows = packed[seg]
        nz_mask = deg[cluster_rows] > 0
        nz_rows = cluster_rows[nz_mask]
        z_rows = cluster_rows[~nz_mask]
        if nz_rows.size == 0:
            new_order[pos : pos + cluster_rows.size] = cluster_rows
            pos += cluster_rows.size
            continue
        starts = row_ptr[nz_rows]
        cnts = deg[nz_rows]
        if nz_rows.size <= exact_limit:
            # (n_local, n_kblocks) membership built by flat fancy indexing
            tot = int(cnts.sum())
            flat_pos = np.arange(tot) - np.repeat(np.cumsum(cnts) - cnts, cnts)
            src = np.repeat(starts, cnts) + flat_pos
            mask = np.zeros((nz_rows.size, n_kblocks), np.int8)
            mask[np.repeat(np.arange(nz_rows.size), cnts), ub[src]] = 1
            ordered = _jaccard_greedy_windows(nz_rows, mask, bm)
        else:
            # signature sort: adjacent rows share leading blocks
            sig1 = ub[starts]
            sig2 = ub[starts + cnts // 2]
            sig3 = cnts
            ordered = nz_rows[np.lexsort((sig3, sig2, sig1))]
        new_order[pos : pos + ordered.size] = ordered
        pos += ordered.size
        new_order[pos : pos + z_rows.size] = z_rows
        pos += z_rows.size

    assert pos == m
    return new_order


def reorder(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    bm: int,
    bk: int,
    enable_global: bool = True,
    enable_local: bool = True,
    reorder_cols: bool = True,
    max_clusters: int = 64,
    seed: int = 0,
) -> ReorderResult:
    """Full global-local pipeline.  Returns final row/col orders."""
    m, k = shape
    if enable_global:
        g = global_reorder(
            rows, cols, shape, max_clusters=max_clusters,
            reorder_cols=reorder_cols, seed=seed,
            min_cluster_rows=max(8, 4 * bm),
        )
    else:
        g = ReorderResult(
            row_order=np.arange(m, dtype=np.int64),
            col_order=np.arange(k, dtype=np.int64),
            cluster_of_row=np.zeros(m, np.int64),
            n_clusters=1,
        )
    if enable_local and np.asarray(rows).size:
        row_order = local_reorder(rows, cols, shape, g, bm, bk)
    else:
        row_order = g.row_order
    # recompute cluster labels for the final order
    cluster_lookup = np.zeros(m, np.int64)
    cluster_lookup[g.row_order] = g.cluster_of_row
    return ReorderResult(
        row_order=row_order,
        col_order=g.col_order,
        cluster_of_row=cluster_lookup[row_order],
        n_clusters=g.n_clusters,
    )


def density_improvement(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    bm: int,
    bk: int,
    row_order: Optional[np.ndarray] = None,
    col_order: Optional[np.ndarray] = None,
) -> float:
    """Mean active-tile density (paper Fig. 21 metric: rho = NNZ/(M*K) over
    stored tiles).  Higher is better."""
    m, k = shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size == 0:
        return 0.0
    if row_order is not None:
        inv = np.empty(m, np.int64)
        inv[row_order] = np.arange(m)
        rows = inv[rows]
    if col_order is not None:
        invc = np.empty(k, np.int64)
        invc[col_order] = np.arange(k)
        cols = invc[cols]
    nkb = (k + bk - 1) // bk
    keys = (rows // bm) * nkb + (cols // bk)
    active = sorted_unique(keys).size
    return rows.size / float(active * bm * bk)
