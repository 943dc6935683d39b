"""``"generator": "chung_lu_gcn"``: ``chung_lu``'s graph with the diagonal
added, as a GCN or a graph transformer aggregates it: ``chung_lu``'s keys
(``n``, ``nonzeros``, ``avg_degree``, ``skew``, ``seed``) and ``classes``.

The structure is ``generators/chung_lu.py``'s from the same keys, loaded
and not copied, so it is the very graph ``chung_lu`` gives, plus one
nonzero at (i, i) for every node: ``nonzeros + n`` entries, sorted by row
and then column.  Its values are D^-1/2 (A + I) D^-1/2 (D the degree of
A + I), worked out in float64 and stored as float32.  Its labels are
uniform over ``classes``, drawn from the graph's seed plus 2 (the seed
plus 1 draws the training split, as ``gcn_full_batch`` does).
"""
from pathlib import Path

import numpy as np
import torch

from nsbench.harness import load_module


def _chung_lu():
    return load_module(Path(__file__).with_name("chung_lu.py"))


def build(g, device):
    rows, cols, _, shape, _ = _chung_lu().build(g, device)
    n = int(shape[0])
    key = torch.cat([torch.from_numpy(rows).to(device) * n
                     + torch.from_numpy(cols).to(device),
                     torch.arange(n, device=device) * (n + 1)])
    key = torch.sort(key).values
    r, c = key // n, key % n
    del key
    d = torch.bincount(r, minlength=n).double().rsqrt_()
    vals = (d[r] * d[c]).float()
    labels = np.random.RandomState(int(g["seed"]) + 2).randint(
        0, int(g["classes"]), n)
    return (r.cpu().numpy(), c.cpu().numpy(), vals.cpu().numpy(), (n, n),
            labels)
