"""``"generator": "chung_lu"``: an undirected graph with a given number of
edges, as a symmetric matrix with exactly ``nonzeros`` entries and no
self-loops: ``n``, ``nonzeros``, ``avg_degree``, ``skew``, ``seed``.

Each node gets a weight from a power law (Pareto of shape ``skew`` plus 1,
scaled to a mean of ``avg_degree`` and capped at ``n``: the program's own
degree law).  Both ends of an edge are drawn in proportion to the weights
(Chung and Lu's model), so a column holds as many nonzeros as its row, as
in any undirected graph.  Draws repeat until ``nonzeros / 2`` distinct
pairs are found; the first that many, in the order drawn, are kept.  The
draws run on the device from a generator seeded with ``seed``, so the
structure is fixed by the configuration on a device of one type.
"""
import numpy as np
import torch


def weights(n: int, avg_degree: float, skew: float, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    w = rng.pareto(skew, n) + 1.0
    w = np.minimum(w / w.mean() * avg_degree, n).astype(np.int64)
    return np.maximum(w, 1)


def build(g, device):
    n, nnz = int(g["n"]), int(g["nonzeros"])
    if nnz % 2:
        raise ValueError("a symmetric matrix without self-loops has an even "
                         "number of nonzeros")
    want = nnz // 2
    w = torch.from_numpy(weights(n, g["avg_degree"], g["skew"], g["seed"]))
    cdf = torch.cumsum(w.to(device, torch.float64), 0)
    cdf /= cdf[-1].clone()
    gen = torch.Generator(device=device).manual_seed(int(g["seed"]))

    def ends(count):
        u = torch.rand(count, dtype=torch.float64, generator=gen,
                       device=device)
        return torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)

    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw, have = want, 0
    while True:
        u, v = ends(draw), ends(draw)
        k = torch.minimum(u, v) * n + torch.maximum(u, v)
        keys = torch.cat([keys, k[u != v]])
        uniq, inv = torch.unique(keys, return_inverse=True)
        if uniq.numel() >= want:
            break
        found = uniq.numel() - have
        have = uniq.numel()
        draw = int(1.2 * (want - have) * draw / max(found, 1)) + 1024
    first = torch.full((uniq.numel(),), keys.numel(), dtype=torch.int64,
                       device=device).scatter_reduce_(
        0, inv, torch.arange(keys.numel(), device=device), "amin")
    keep = uniq[torch.argsort(first)[:want]]
    del keys, inv, first, uniq
    lo, hi = keep // n, keep % n
    key = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    return ((key // n).cpu().numpy(), (key % n).cpu().numpy(), None, (n, n),
            None)
