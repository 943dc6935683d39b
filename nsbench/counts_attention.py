"""The yardstick's arithmetic for graph attention: the operations and
bytes of one SDDMM at a pattern, and of one UniMP forward's sparse
products.

As in ``counts.py``, every count is of the work the problem needs: for
the SDDMM ``(Q Kᵀ)`` sampled at A's nonzeros, Q (m, d) and K (k, d) read
once, the pattern read once as CSR (int32 column indices, m + 1 int32 row
offsets) and one fp32 value written per nonzero; one multiply-add per
nonzero and column of Q.  A call batched over heads reads the pattern
once for all of them, and each head's Q and K and writes each head's
values.  Padding and what a kernel reads again are not counted.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from nsbench.counts import INDEX_BYTES, PEAKS, VALUE_BYTES, spmm_flops


def sddmm_flops(nnz: int, d: int, heads: int = 1) -> float:
    """One multiply and one add per nonzero, head and column of Q."""
    return 2.0 * heads * nnz * d


def sddmm_bytes(m: int, k: int, nnz: int, d: int, heads: int = 1) -> float:
    """One SDDMM call batched over ``heads``: Q and K of every head once,
    the pattern as CSR once for all heads, the values of every head
    written once."""
    operands = heads * (m + k) * d * VALUE_BYTES
    pattern = nnz * INDEX_BYTES + (m + 1) * INDEX_BYTES
    return float(operands + pattern + heads * nnz * VALUE_BYTES)


def sddmm_bound_s(m: int, k: int, nnz: int, d: int, heads: int = 1,
                  peaks: Dict[str, float] = PEAKS) -> float:
    """The least time the chip could take for one SDDMM call over
    ``heads`` heads."""
    return max(sddmm_bytes(m, k, nnz, d, heads) / peaks["hbm_bytes_per_s"],
               sddmm_flops(nnz, d, heads) / peaks["tf32_flops_per_s"])


def unimp_layers(cfg: dict) -> List[Tuple[int, int, int, bool]]:
    """``(d_in, heads, head width, concat)`` of each UniMP layer of a
    configuration: every layer but the last ``hidden // heads`` wide and
    concatenated, the last ``classes`` wide and averaged."""
    u = cfg["unimp"]
    heads, hidden, n = u["heads"], u["hidden"], u["num_layers"]
    return [(cfg["features"] if i == 0 else hidden, heads,
             cfg["classes"] if i == n - 1 else hidden // heads, i < n - 1)
            for i in range(n)]


def unimp_heads(cfg: dict) -> List[int]:
    """The head width of every SDDMM and SpMM of one forward, head by
    head."""
    return [c for _, h, c, _ in unimp_layers(cfg) for _ in range(h)]


def unimp_spmm_flops(nnz: int, head_widths: Sequence[int]) -> float:
    """The SpMMs of one forward: one per head, ``A_α @ V_h``."""
    return sum(spmm_flops(nnz, c) for c in head_widths)


def unimp_sddmm_bound_s(m: int, nnz: int,
                        layers: Sequence[Tuple[int, int]],
                        peaks: Dict[str, float] = PEAKS) -> float:
    """The least time the chip could take for the SDDMMs of one forward:
    one call per layer, ``(heads, head width)`` in ``layers``, Q and K
    each (m, C) per head."""
    return sum(sddmm_bound_s(m, m, nnz, c, h, peaks) for h, c in layers)
