"""The yardstick's arithmetic: the chip's peaks, the operations and bytes
of one SpMM and of one GCN epoch, and the statistics of a window.

Every count here is of the work the problem needs, whatever implements
it: A read once as CSR, B read once, C written once; one multiply-add per
stored nonzero and column of B.  Padding, tile zeros and what a kernel
reads again are not counted.
"""
from __future__ import annotations

import statistics
from typing import Dict, Sequence

# NVIDIA H100 SXM, NVIDIA's data sheet (dense rates, at the 700 W limit)
PEAKS: Dict[str, float] = {
    "hbm_bytes_per_s": 3.35e12,
    # the TF32 tensor-core rate: the highest at which the chip computes
    # fp32 inputs, so no share of it can read above 100 %
    "tf32_flops_per_s": 495e12,
}
INDEX_BYTES = 4  # int32 CSR column indices and row offsets
VALUE_BYTES = 4  # fp32 values, operands and results


def spmm_flops(nnz: int, n: int) -> float:
    """One multiply and one add per stored nonzero and column of B."""
    return 2.0 * nnz * n


def spmm_bytes(m: int, k: int, nnz: int, n: int) -> float:
    """A as CSR once (values, column indices, m + 1 row offsets), B read
    once and C written once."""
    a = nnz * (VALUE_BYTES + INDEX_BYTES) + (m + 1) * INDEX_BYTES
    return float(a + k * n * VALUE_BYTES + m * n * VALUE_BYTES)


def spmm_bound_s(m: int, k: int, nnz: int, n: int,
                 peaks: Dict[str, float] = PEAKS) -> float:
    """The least time the chip could take for one SpMM."""
    return max(spmm_bytes(m, k, nnz, n) / peaks["hbm_bytes_per_s"],
               spmm_flops(nnz, n) / peaks["tf32_flops_per_s"])


def gcn_epoch_flops(n: int, nnz: int,
                    widths: Sequence[int]) -> Dict[str, float]:
    """Model FLOPs of one full-batch epoch of a GCN whose layers are
    ``A @ (H W)`` with the given widths (input, hidden..., classes): every
    matmul and SpMM of the forward and the backward, from the shapes.
    Biases, batch norm, dropout, the softmax and the optimizer are left
    out; X takes no gradient, so the first layer has no input gradient."""
    fwd = bwd = 0.0
    for layer, (din, dout) in enumerate(zip(widths, widths[1:])):
        fwd += 2.0 * n * din * dout + spmm_flops(nnz, dout)  # H W, A (H W)
        bwd += spmm_flops(nnz, dout) + 2.0 * n * din * dout  # Aᵀ G, Hᵀ (Aᵀ G)
        if layer:
            bwd += 2.0 * n * din * dout                      # (Aᵀ G) Wᵀ
    return {"forward": fwd, "backward": bwd, "epoch": fwd + bwd}


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every sample (Python's ``quantiles`` with
    n=100, exclusive method); one sample is its own percentile."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100)[94])


def gflops(flops_per_call: float, calls: int, window_s: float) -> float:
    """Useful work over the whole window, in GFLOP/s."""
    return flops_per_call * calls / window_s / 1e9
