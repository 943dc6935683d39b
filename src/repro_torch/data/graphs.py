"""Synthetic sparse-matrix generators mirroring the paper's dataset shapes.

The paper evaluates on SuiteSparse + GNN graphs (Table 2) whose key
structural axes are density, skew (fraction of NNZ in the top-10% rows),
and empty-tile fraction.  These generators reproduce those axes at
configurable scale so every benchmark table has a corresponding workload:

- ``power_law``: Zipf-distributed row degrees (cora/reddit/ogbn-like skew)
- ``rmat``: RMAT kronecker-style clustering (community block structure)
- ``banded``: diagonal-band FEM-style matrices (F1/Fault_639-like, high
  empty-tile fraction at 128-granularity)
- ``nm_pruned`` / ``unstructured_pruned``: DLMC-style pruned-DNN weight
  matrices — magnitude pruning of a seeded Gaussian weight matrix, either
  per m-wide group (an exact N:M pattern, the structured fast lane's
  target) or globally at the same density (its unstructured control)
- ``PAPER_DATASETS``: scaled-down stand-ins for the paper's Table 2 rows.
- ``mutate``: a seeded mutation stream (edge inserts and deletes, weight
  updates) for the dynamic plans.

A copy of ``repro.data.graphs``: the same spec and seed give the same
triplets in both packages, and ``mutate`` the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    m: int
    k: int
    avg_degree: float
    kind: str = "power_law"  # power_law | rmat | banded | uniform
                             # | nm_pruned | unstructured_pruned
    skew: float = 1.1        # pareto exponent (lower = more skew)
    seed: int = 0
    nm: Tuple[int, int] = (0, 0)  # (n, m) pattern for kind="nm_pruned"


def _dedupe(rows: np.ndarray, cols: np.ndarray, shape) -> Tuple[np.ndarray, np.ndarray]:
    keys = rows.astype(np.int64) * shape[1] + cols
    keys = np.unique(keys)
    return (keys // shape[1]).astype(np.int64), (keys % shape[1]).astype(np.int64)


def generate(spec: GraphSpec) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns deduped, sorted (rows, cols, vals)."""
    rng = np.random.RandomState(spec.seed)
    m, k = spec.m, spec.k
    target_nnz = int(spec.avg_degree * m)

    if spec.kind == "power_law":
        deg = rng.pareto(spec.skew, m) + 1.0
        deg = np.minimum(deg / deg.mean() * spec.avg_degree, k).astype(np.int64)
        deg = np.maximum(deg, 1)
        rows = np.repeat(np.arange(m), deg)
        # preferential-attachment-ish columns: zipf over columns
        cols = (k * rng.power(0.3, rows.size)).astype(np.int64) % k
    elif spec.kind == "rmat":
        n_bits_r = int(np.ceil(np.log2(max(m, 2))))
        n_bits_c = int(np.ceil(np.log2(max(k, 2))))
        e = target_nnz
        rows = np.zeros(e, np.int64)
        cols = np.zeros(e, np.int64)
        a, b, c = 0.57, 0.19, 0.19
        for bit in range(max(n_bits_r, n_bits_c)):
            r = rng.random(e)
            go_right = (r > a + b) & (r <= a + b + c) | (r > a + b + c)
            go_down = (r > a) & (r <= a + b) | (r > a + b + c)
            if bit < n_bits_r:
                rows |= go_down.astype(np.int64) << bit
            if bit < n_bits_c:
                cols |= go_right.astype(np.int64) << bit
        rows %= m
        cols %= k
    elif spec.kind == "banded":
        band = max(2, int(spec.avg_degree))
        rows = np.repeat(np.arange(m), band)
        offs = rng.randint(-band, band + 1, rows.size)
        cols = np.clip((rows * k) // m + offs, 0, k - 1)
    elif spec.kind == "nm_pruned":
        # DLMC-style structured pruning: keep the n largest-magnitude
        # weights of every m-wide group of each row of a dense Gaussian
        # weight matrix — an exact N:M pattern by construction
        n_pat, m_pat = spec.nm
        assert 0 < n_pat <= m_pat, spec.nm
        gk = k // m_pat  # a non-multiple tail stays unpruned-empty
        w = np.abs(rng.randn(m, gk, m_pat))
        top = np.argsort(w, axis=2)[:, :, m_pat - n_pat:]
        rows = np.repeat(np.arange(m), gk * n_pat)
        base = np.broadcast_to(
            np.arange(gk)[None, :, None] * m_pat, top.shape)
        cols = (base + top).reshape(-1)
    elif spec.kind == "unstructured_pruned":
        # the unstructured control: same magnitude pruning, same density,
        # no group constraint
        w = np.abs(rng.randn(m, k)).ravel()
        keep = np.argpartition(-w, min(target_nnz, w.size - 1))[:target_nnz]
        rows = keep // k
        cols = keep % k
    else:  # uniform
        rows = rng.randint(0, m, target_nnz)
        cols = rng.randint(0, k, target_nnz)

    rows, cols = _dedupe(rows, cols, (m, k))
    vals = rng.randn(rows.size).astype(np.float32)
    return rows, cols, vals


# Scaled stand-ins for the paper's Table 2 (same density/skew character)
PAPER_DATASETS: Dict[str, GraphSpec] = {
    "cora":        GraphSpec("cora", 2708, 2708, 3.9, "power_law", 1.6, 1),
    "wiki-RfA":    GraphSpec("wiki-RfA", 4096, 4096, 31.8, "power_law", 1.1, 2),
    "ogbn-arxiv":  GraphSpec("ogbn-arxiv", 8192, 8192, 13.6, "power_law", 1.3, 3),
    "pattern1":    GraphSpec("pattern1", 4096, 4096, 96.0, "rmat", 1.0, 4),
    "mip1":        GraphSpec("mip1", 8192, 8192, 52.0, "rmat", 1.0, 5),
    "nd12k":       GraphSpec("nd12k", 6000, 6000, 98.0, "banded", 1.0, 6),
    "human_gene1": GraphSpec("human_gene1", 4096, 4096, 220.0, "uniform", 1.0, 7),
    "F1":          GraphSpec("F1", 16384, 16384, 19.0, "banded", 1.0, 8),
    "mouse_gene":  GraphSpec("mouse_gene", 8192, 8192, 128.0, "uniform", 1.0, 9),
    "reddit":      GraphSpec("reddit", 16384, 16384, 120.0, "power_law", 1.05, 10),
    "amazon":      GraphSpec("amazon", 32768, 32768, 12.0, "power_law", 1.2, 11),
    "mycielskian": GraphSpec("mycielskian", 8192, 8192, 380.0, "rmat", 1.0, 12),
    # DLMC-style pruned-DNN weights (transformer/ResNet layer shapes at the
    # 94-97% sparsities the structured fast lane targets) + an unstructured
    # control at the same density
    "dlmc-nm-1-32": GraphSpec("dlmc-nm-1-32", 4096, 4096, 128.0,
                              "nm_pruned", 1.0, 13, nm=(1, 32)),
    "dlmc-nm-2-32": GraphSpec("dlmc-nm-2-32", 4096, 4096, 256.0,
                              "nm_pruned", 1.0, 14, nm=(2, 32)),
    "dlmc-unstr":   GraphSpec("dlmc-unstr", 4096, 4096, 128.0,
                              "unstructured_pruned", 1.0, 15),
}


def mutate(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    steps: int = 10,
    insert_frac: float = 0.02,
    delete_frac: float = 0.02,
    update_frac: float = 0.05,
    seed: int = 0,
) -> Iterator["GraphDelta"]:  # noqa: F821 (imported lazily)
    """Yield a seeded stream of ``dynamic.GraphDelta`` mutation batches.

    Each step inserts ``insert_frac * nnz`` absent edges, deletes
    ``delete_frac * nnz`` live edges and re-weights ``update_frac * nnz``
    live edges, tracking the evolving structure so that deletes always
    target live entries and inserts always target holes (what
    ``DynamicPlan.update`` enforces).  Fractions are of the *current* nnz.
    The reference's generator, draw for draw.
    """
    from ..dynamic.delta import GraphDelta  # generators stay import-light

    m, k = shape
    rng = np.random.RandomState(seed)
    live: Dict[int, float] = {
        int(r) * k + int(c): float(v)
        for r, c, v in zip(rows, cols, vals)
    }
    for _ in range(steps):
        nnz = max(len(live), 1)
        n_ins = int(round(insert_frac * nnz))
        n_del = min(int(round(delete_frac * nnz)), max(len(live) - 1, 0))
        n_upd = min(int(round(update_frac * nnz)), len(live))

        live_keys = np.fromiter(live, np.int64, count=len(live))
        del_keys = rng.choice(live_keys, n_del, replace=False) if n_del \
            else np.zeros(0, np.int64)
        remaining = np.setdiff1d(live_keys, del_keys)
        upd_keys = (
            rng.choice(remaining, min(n_upd, remaining.size), replace=False)
            if remaining.size and n_upd else np.zeros(0, np.int64)
        )
        ins_keys: list = []
        taken = set(live)
        attempts = 0
        while len(ins_keys) < n_ins and attempts < 100:  # dense-matrix guard
            attempts += 1
            cand = rng.randint(0, m, n_ins) * np.int64(k) + rng.randint(
                0, k, n_ins)
            for key in cand:
                key = int(key)
                if key not in taken:
                    taken.add(key)
                    ins_keys.append(key)
                    if len(ins_keys) == n_ins:
                        break
        ins_keys = np.asarray(ins_keys, np.int64)
        ins_vals = rng.randn(ins_keys.size)
        upd_vals = rng.randn(upd_keys.size)

        for key in del_keys:
            del live[int(key)]
        for key, v in zip(upd_keys, upd_vals):
            live[int(key)] = float(v)
        for key, v in zip(ins_keys, ins_vals):
            live[int(key)] = float(v)

        yield GraphDelta(
            ins_rows=ins_keys // k, ins_cols=ins_keys % k,
            ins_vals=ins_vals,
            del_rows=del_keys // k, del_cols=del_keys % k,
            upd_rows=upd_keys // k, upd_cols=upd_keys % k,
            upd_vals=upd_vals,
        )


def dataset_stats(rows: np.ndarray, cols: np.ndarray, shape) -> Dict[str, float]:
    m, k = shape
    nnz = rows.size
    row_cnt = np.zeros(m, np.int64)
    np.add.at(row_cnt, rows, 1)
    top = np.sort(row_cnt)[::-1][: max(m // 10, 1)].sum()
    t = 16
    keys = (rows // t) * ((k + t - 1) // t) + (cols // t)
    active = np.unique(keys).size
    total_tiles = ((m + t - 1) // t) * ((k + t - 1) // t)
    return {
        "nnz": float(nnz),
        "density": nnz / (m * k),
        "avg_len": nnz / m,
        "skew_top10": float(top) / max(nnz, 1),
        "empty_tiles_16": 1.0 - active / total_tiles,
    }
