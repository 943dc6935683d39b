"""GCN training where every aggregation is a coordinated SpMM: the port of
``examples/gcn_training.py``.

A two-layer GCN, ``A @ relu(A @ (X W1)) W2`` with A the symmetrically
normalised adjacency of a planted-community graph, trained full-batch by
gradient descent on the cross-entropy of every node.  Each forward runs two
SpMMs on A (two ``SparseGraphConv`` layers), and each backward two SpMMs on
the transpose plan of A (``exec.api.SpMMFunction``).

    PYTHONPATH=src python -m repro_torch.examples.gcn_training \\
        [--device cpu] [--epochs 200] [--hidden 64]

Runs on the card by default; ``--device cpu`` runs the plain versions.  It
asserts a train accuracy above 0.9.
"""
import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import repro_torch.sparse as sp
from repro_torch.core.arrays import sorted_unique
from repro_torch.models import SparseGraphConv


def make_graph(n=2048, avg_deg=12, n_classes=16, seed=0, homophily=0.85,
               n_features=64, symmetric=False):
    """Stochastic block model with power-law degrees: labels follow the
    community structure, so aggregation carries the class signal.  The
    reference's generator with the feature width as a parameter, and the
    option to symmetrise the edges before the self-loops are added (as
    GCN baselines do with a directed graph such as ogbn-arxiv's): at the
    defaults it gives the reference's graph, bit for bit."""
    rng = np.random.RandomState(seed)
    labels = (np.arange(n) * n_classes // n).astype(np.int32)
    block = n // n_classes
    deg = np.minimum((rng.pareto(1.3, n) + 1) * avg_deg / 2, n // 4).astype(int)
    deg = np.maximum(deg, 2)
    rows = np.repeat(np.arange(n), deg)
    same = rng.rand(rows.size) < homophily
    intra = (labels[rows] * block + rng.randint(0, block, rows.size))
    inter = rng.randint(0, n, rows.size)
    cols = np.where(same, intra, inter)
    if symmetric:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
    # symmetric normalize: A_hat = D^-1/2 (A + I) D^-1/2
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    key = sorted_unique(rows * n + cols)
    rows, cols = key // n, key % n
    d = np.bincount(rows, minlength=n).astype(np.float32)
    vals = (d[rows] ** -0.5) * (d[cols] ** -0.5)
    feats = rng.randn(n, n_features).astype(np.float32)
    feats[:, :n_classes] += 0.4 * np.eye(n_classes, dtype=np.float32)[labels]
    return rows, cols, vals, feats, labels, n_classes


class GCN(nn.Module):
    """Two ``SparseGraphConv`` layers on one graph with a ReLU between:
    ``A @ relu(A @ (X W1)) W2``, the logits."""

    def __init__(self, a, w1: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.conv1 = SparseGraphConv(a, w1)
        self.conv2 = SparseGraphConv(a, w2)

    @classmethod
    def init(cls, a, d_in: int, hidden: int, n_classes: int,
             generator: Optional[torch.Generator] = None,
             scale: float = 0.1) -> "GCN":
        """Weights drawn N(0, scale²), as the reference draws them."""
        dev = a.device if generator is None else generator.device
        w1 = torch.randn((d_in, hidden), generator=generator, device=dev)
        w2 = torch.randn((hidden, n_classes), generator=generator, device=dev)
        return cls(a, w1 * scale, w2 * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels, as the reference's."""
    return F.cross_entropy(logits, labels)


def sgd_step(model: nn.Module, x: torch.Tensor, labels: torch.Tensor,
             lr: float) -> torch.Tensor:
    """One full-batch step ``w -= lr * dL/dw``; returns the loss before
    it (detached)."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model(x), labels)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * p.grad
    return loss.detach()


def accuracy(model: nn.Module, x: torch.Tensor,
             labels: torch.Tensor) -> float:
    with torch.no_grad():
        return float((model(x).argmax(-1) == labels).float().mean())


def main(device: str = "cuda", epochs: int = 200, hidden: int = 64,
         seed: int = 0, lr: float = 2.0) -> Tuple[float, float]:
    """Train and return ``(final loss, train accuracy)``."""
    rows, cols, vals, feats, labels, n_classes = make_graph()
    n = feats.shape[0]
    A = sp.from_coo(rows, cols, vals, (n, n), device=device)
    st = A.plan.stats_dict
    print(f"graph: {n} nodes, {len(rows)} edges; alpha={st['alpha']:.4f}, "
          f"fringe={st['fringe_fraction']:.1%}")
    gen = torch.Generator(device=A.device).manual_seed(seed)
    model = GCN.init(A, feats.shape[1], hidden, n_classes, generator=gen)
    x = torch.from_numpy(feats).to(A.device)
    y = torch.from_numpy(labels).long().to(A.device)
    t0 = time.perf_counter()
    loss = None
    for epoch in range(epochs):
        loss = sgd_step(model, x, y, lr)
        if epoch % max(epochs // 10, 1) == 0:
            print(f"epoch {epoch:4d}  loss {float(loss):.4f}")
    dt = time.perf_counter() - t0
    acc = accuracy(model, x, y)
    print(f"final loss {float(loss):.4f}, train acc {acc:.3f}, {epochs} "
          f"epochs in {dt:.1f}s ({1e3 * dt / max(epochs, 1):.1f} ms/epoch)")
    if not acc > 0.9:
        raise RuntimeError(
            f"GCN failed to fit planted communities (train acc {acc:.3f})")
    return float(loss), acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=64)
    args = ap.parse_args()
    main(args.device, args.epochs, args.hidden)
