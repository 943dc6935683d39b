"""GAT-style attention as three facade calls: sddmm -> with_values -> spmm.

Dot-product attention over a graph: the scores are a sampled dense-dense
matmul, ``(Q K^T)/sqrt(d)`` evaluated only at the graph's edges, which is
the SDDMM operator on the prepared plan's pattern.  The softmaxed weights
then replace the plan's values (same signature, same cached executor) and
one coordinated SpMM aggregates.  No dense (N, N) attention matrix exists.

    PYTHONPATH=src python -m repro_torch.examples.gat_attention [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain versions.
"""
import argparse

import numpy as np
import torch

import repro_torch.sparse as sp
from repro_torch.core.arrays import sorted_unique
from repro_torch.exec import dispatch_count, fused_trace_count


def make_graph(n=2048, avg_deg=12, n_classes=16, seed=0, homophily=0.85):
    """Stochastic block model with power-law degrees and symmetric
    normalisation, D^-1/2 (A + I) D^-1/2; 64 features a node."""
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
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    key = sorted_unique(rows * n + cols)
    rows, cols = key // n, key % n
    d = np.bincount(rows, minlength=n).astype(np.float32)
    vals = (d[rows] ** -0.5) * (d[cols] ** -0.5)
    feats = rng.randn(n, 64).astype(np.float32)
    feats[:, :n_classes] += 0.4 * np.eye(n_classes, dtype=np.float32)[labels]
    return rows, cols, vals, feats, labels, n_classes


def main(device: str = "cuda") -> float:
    rows, cols, vals, feats, _labels, _nc = make_graph(n=1024, avg_deg=10)
    n, d = feats.shape
    d_head = 32
    A = sp.from_coo(rows, cols, vals, (n, n), device=device)
    print(f"graph: {n} nodes, {A.nnz} edges")

    rng = np.random.RandomState(0)
    wq = torch.from_numpy((rng.randn(d, d_head) / np.sqrt(d)).astype(np.float32))
    wk = torch.from_numpy((rng.randn(d, d_head) / np.sqrt(d)).astype(np.float32))
    x = torch.from_numpy(feats).to(A.device)
    q, k = x @ wq.to(A.device), x @ wk.to(A.device)

    # 1) SDDMM: per-edge raw scores in input COO order
    e = sp.sddmm(A, q, k.t()) / np.sqrt(d_head)

    # 2) edge softmax per destination row (segment ops over static rows)
    seg = torch.from_numpy(rows).to(A.device)
    e_max = torch.full((n,), -np.inf, device=A.device).scatter_reduce(
        0, seg, e, "amax")
    p = torch.exp(e - e_max[seg])
    denom = torch.zeros(n, device=A.device).index_add_(0, seg, p)
    alpha = p / denom[seg].clamp(min=1e-30)

    # 3) swap the weights into the pattern and aggregate: same executor,
    # with_values rides dynamic.update_values underneath
    A_att = A.with_values(alpha)
    out = sp.spmm(A_att, x)

    # verify against the dense softmax
    qn, kn = q.cpu().double().numpy(), k.cpu().double().numpy()
    dense_scores = qn @ kn.T / np.sqrt(d_head)
    mask = np.zeros((n, n), bool)
    mask[rows, cols] = True
    dense_scores[~mask] = -np.inf
    ref_alpha = np.exp(dense_scores - dense_scores.max(1, keepdims=True))
    ref_alpha /= ref_alpha.sum(1, keepdims=True)
    ref = ref_alpha @ feats.astype(np.float64)
    err = float(np.abs(out.cpu().numpy() - ref).max() / np.abs(ref).max())
    print(f"attention-weighted aggregation -> {tuple(out.shape)}, "
          f"rel err vs dense softmax: {err:.2e}; "
          f"{dispatch_count()} dispatches, {fused_trace_count()} builds")
    assert err < 1e-4, "GAT round trip diverged from the dense softmax"
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
