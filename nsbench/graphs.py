"""A frozen copy of the program's block-model graph generator.

The benchmark makes its graphs itself, so that a later change to the
program's generators cannot change what is measured.  :func:`make_graph`
is ``repro_torch.examples.gcn_training.make_graph`` (a stochastic block
model with power-law degrees, optionally symmetrised, with self-loops and
the normalisation D^-1/2 (A + I) D^-1/2).  It draws the structure from the
configuration's own seed; :func:`sbm_structure` stops before the draws
that follow the structure (the features), which the benchmark takes from
``--seed`` instead, and the structure is the same either way, because
those draws come last.  numpy only: the yardstick imports nothing of the
program.
"""
from __future__ import annotations

import numpy as np


def sorted_unique(a) -> np.ndarray:
    """The distinct values of an integer array, ascending, by sort (a hash
    table, as numpy 2.3's ``np.unique`` uses, takes minutes on 85 M keys)."""
    s = np.sort(np.asarray(a).ravel())
    if s.size < 2:
        return s
    keep = np.empty(s.size, bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def sbm_structure(n: int, avg_deg: float, n_classes: int, seed: int,
                  homophily: float = 0.85, symmetric: bool = False, rng=None):
    """``(rows, cols, vals, labels)`` of the block-model graph: the
    normalised adjacency D^-1/2 (A + I) D^-1/2 and each node's community."""
    rng = np.random.RandomState(seed) if rng is None else rng
    labels = (np.arange(n) * n_classes // n).astype(np.int32)
    block = n // n_classes
    deg = np.minimum((rng.pareto(1.3, n) + 1) * avg_deg / 2,
                     n // 4).astype(int)
    deg = np.maximum(deg, 2)
    rows = np.repeat(np.arange(n), deg)
    same = rng.rand(rows.size) < homophily
    intra = (labels[rows] * block + rng.randint(0, block, rows.size))
    inter = rng.randint(0, n, rows.size)
    cols = np.where(same, intra, inter)
    if symmetric:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    key = sorted_unique(rows * n + cols)
    rows, cols = key // n, key % n
    d = np.bincount(rows, minlength=n).astype(np.float32)
    vals = (d[rows] ** -0.5) * (d[cols] ** -0.5)
    return rows, cols, vals, labels


def make_graph(n: int = 2048, avg_deg: float = 12, n_classes: int = 16,
               seed: int = 0, homophily: float = 0.85, n_features: int = 64,
               symmetric: bool = False):
    """``(rows, cols, vals, feats, labels, n_classes)`` as the program's
    ``make_graph`` gives them."""
    rng = np.random.RandomState(seed)
    rows, cols, vals, labels = sbm_structure(
        n, avg_deg, n_classes, seed, homophily, symmetric, rng)
    feats = rng.randn(n, n_features).astype(np.float32)
    feats[:, :n_classes] += 0.4 * np.eye(n_classes, dtype=np.float32)[labels]
    return rows, cols, vals, feats, labels, n_classes
