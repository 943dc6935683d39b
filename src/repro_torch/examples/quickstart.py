"""Quickstart: coordinated SpMM on a power-law graph.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain versions.
"""
import argparse

import numpy as np
import torch

import repro_torch.sparse as sp
from repro_torch.data import graphs
from repro_torch.exec import fused_trace_count


def main(device: str = "cuda") -> float:
    # 1) a skewed sparse matrix (reddit-like character, scaled down)
    spec = graphs.PAPER_DATASETS["ogbn-arxiv"]
    rows, cols, vals, shape = *graphs.generate(spec), (spec.m, spec.k)
    stats = graphs.dataset_stats(rows, cols, shape)
    print(f"A: {shape}, nnz={int(stats['nnz'])}, "
          f"density={stats['density']:.2e}, skew={stats['skew_top10']:.2f}")

    # 2) prepare once (cost-model split -> reorder -> tile stream -> fringe);
    # from_coo returns a SparseMatrix handle fronting the prepared plan
    A = sp.from_coo(rows, cols, vals, shape, device=device)
    sd = A.plan.stats_dict
    print(f"alpha={sd['alpha']:.4f}  fringe={sd['fringe_fraction']:.1%} of nnz"
          f"  tile_density={sd['tile_density']:.3f}"
          f"  reuse_factor={sd['reuse_factor']:.2f}  tier={A.plan.fringe_tier}")

    # 3) execute against any dense operand: one call runs both engine paths
    # and the merge; the executor is cached per plan signature, so epoch
    # loops build it once
    b = torch.from_numpy(
        np.random.RandomState(0).randn(shape[1], 128).astype(np.float32)
    ).to(A.device)
    builds = fused_trace_count()
    out = sp.spmm(A, b)
    for _ in range(3):  # later epochs reuse the executor
        out = A @ b     # operator sugar for sp.spmm(A, b)
    print(f"executor builds over 4 epochs: {fused_trace_count() - builds}")

    # 4) verify against the dense product
    want = A.dense() @ b.cpu().numpy().astype(np.float64)
    err = float(np.abs(out.cpu().numpy() - want).max())
    print(f"C = A @ B -> {tuple(out.shape)}, max abs err vs dense: {err:.2e}")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
