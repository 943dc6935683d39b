"""Architecture-aware cost model (paper §5.2.1): split rates and dispatch tiers.

The paper derives a density threshold from per-engine throughputs

    alpha = r * P_AIV / P_AIC            (Eq. 3)

where the vector engine's cost is proportional to NNZ and the matrix
engine's cost to the full tile volume M*K (Eq. 1).  Tiles with density
below alpha go to the vector path; the rest to the matrix path.

This module keeps the analytic model, the matrix-format pricing and the
vector-path tier selection of ``repro.core.cost_model``, with the same
arithmetic, so plans built from the same COO and config have the same
leaves.  The deliberate differences are the H100 tier rules in
:func:`select_fringe_tier` and :func:`select_sddmm_tier`.

Two calibration modes, as in the reference: ``analytic_tpu`` derives the
rates from the reference's roofline constants, and ``measure`` times the
two paths on the current device through the synchronised
``tuner.timed_best_of`` (the paper's microbenchmark dry run).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

# The reference's TPU constants, kept so that plan leaves match the JAX
# package's (the split threshold, reuse capacities and fringe tiers are all
# derived from them).  They do not describe the H100; re-deriving them for
# it is the ROADMAP item "Tuner and cost model, re-derived for the H100".
PEAK_FLOPS_BF16 = 197e12  # per chip
HBM_BW = 819e9  # bytes/s
ICI_BW = 50e9  # bytes/s/link
VMEM_BYTES = 16 * 1024 * 1024
MXU_DIM = 128  # systolic array edge; min efficient tile
VPU_LANES = 128
SUBLANES = 8

# The card's ceilings, from NVIDIA's data sheet for the H100 SXM at its
# 700 W limit: HBM3 bandwidth and the fp32 rate outside the tensor cores.
# The telemetry roofline (``obs.report``) prices dispatches against them;
# the split above still runs on the TPU constants.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12


@dataclasses.dataclass
class EngineCostModel:
    """Predicts per-path execution cost and the split threshold alpha."""

    p_matrix: float  # matrix-path rate: dense tile elements / second
    p_vector: float  # vector-path rate: nonzeros / second
    r: float = 1.0   # capacity ratio (paper's r; engine-count analogue)
    n_cols: int = 256  # dense operand width N the rates were calibrated for

    # --- Eq. (1) ---
    def cost_vector(self, nnz: float) -> float:
        return nnz / self.p_vector

    def cost_matrix(self, m: float, k: float) -> float:
        return (m * k) / self.p_matrix

    # --- Eq. (3) ---
    @property
    def alpha(self) -> float:
        a = self.r * self.p_vector / self.p_matrix
        return float(np.clip(a, 1e-6, 1.0))

    def length_threshold(self, k: int) -> float:
        """Eq. (5): convert the density boundary into a row-length bound."""
        return self.alpha * k

    @classmethod
    def analytic_tpu(cls, n_cols: int = 256, mxu_efficiency: float = 0.7,
                     r: float = 1.0) -> "EngineCostModel":
        """Roofline-derived rates from the reference's constants.

        Matrix path: each dense A element drives 2*N flops (compute-bound
        once tiles are dense).  Vector path: each nonzero touches one N-wide
        bf16 row of B (bound by memory bandwidth).
        """
        p_matrix = mxu_efficiency * PEAK_FLOPS_BF16 / (2.0 * n_cols)
        bytes_per_nnz = n_cols * 2  # gather of one bf16 B row
        p_vector = HBM_BW / bytes_per_nnz
        return cls(p_matrix=p_matrix, p_vector=p_vector, r=r, n_cols=n_cols)

    @classmethod
    def measure(
        cls,
        matrix_bench: Callable[[], object],
        vector_bench: Callable[[], object],
        matrix_work_elems: float,
        vector_work_nnz: float,
        r: float = 1.0,
        n_cols: int = 256,
        repeats: int = 3,
    ) -> "EngineCostModel":
        """Paper-style microbenchmark calibration (§5.2.1 'dry run').

        ``*_bench`` are zero-arg callables that run one pass of the
        respective path over a workload of the given size.  A CUDA bench
        returns once its kernels are queued, so each is timed through the
        synchronised ``tuner.timed_best_of`` (function-local import, as in
        the reference).
        """
        from .tuner import timed_best_of

        tm = timed_best_of(matrix_bench, repeats=repeats, warmup=1)
        tv = timed_best_of(vector_bench, repeats=repeats, warmup=1)
        return cls(
            p_matrix=matrix_work_elems / tm,
            p_vector=vector_work_nnz / tv,
            r=r,
            n_cols=n_cols,
        )

    # --- Eq. (7): residual split target ---
    def split_residual(
        self, nnz_candidates: np.ndarray, rows_candidates: np.ndarray, k: int
    ) -> int:
        """Pick a prefix count c of candidate units (sorted sparse-first) for
        the vector path so that NNZ(vec) / (M(mat) * K) ≈ alpha."""
        total_rows = float(rows_candidates.sum())
        csum_nnz = np.concatenate(
            [[0.0], np.cumsum(nnz_candidates, dtype=np.float64)])
        csum_rows = np.concatenate(
            [[0.0], np.cumsum(rows_candidates, dtype=np.float64)])
        mat_rows = np.maximum(total_rows - csum_rows, 1.0)
        ratio = csum_nnz / (mat_rows * k)
        return int(np.argmin(np.abs(ratio - self.alpha)))

    def predict_baldu(self, nnz_vec: float, m_mat: float, k: int) -> float:
        """Predicted finish-time imbalance (max/min) of a proposed split."""
        tv = self.cost_vector(max(nnz_vec, 1.0))
        tm = self.cost_matrix(max(m_mat, 1.0), k)
        return max(tv, tm) / max(min(tv, tm), 1e-12)

    # --- dispatch-decision hooks (prepare consults these on the instance) ---

    def select_fringe_tier(
        self, k: int, num_rows: int, bn: int,
        vmem_budget: Optional[int] = None, impl: str = "torch",
    ) -> tuple:
        return select_fringe_tier(k, num_rows, bn, vmem_budget=vmem_budget,
                                  impl=impl)

    def imbalance_threshold(self) -> float:
        """Max tolerated LPT row imbalance before rhs-sharding wins."""
        return ROWS_IMBALANCE_THRESHOLD

    def select_matrix_format(
        self, *, nm_pattern: Optional[tuple], tile_zero_fraction: float,
        num_steps: int, bm: int, bk: int, row_cap: int, hint=None,
    ) -> str:
        return select_matrix_format(
            nm_pattern=nm_pattern, tile_zero_fraction=tile_zero_fraction,
            num_steps=num_steps, bm=bm, bk=bk, row_cap=row_cap, hint=hint,
        )


def default_cost_model(n_cols: int = 256) -> EngineCostModel:
    return EngineCostModel.analytic_tpu(n_cols=n_cols)


# --- structured matrix-path payload format -----------------------------------
STRUCTURED_BYTES_HYSTERESIS = 0.7   # packed bytes must be <= 70% of general


def matrix_payload_bytes(
    fmt: str, num_steps: int, bm: int, bk: int,
    *, nm_pattern: Optional[tuple] = None, row_cap: int = 0,
) -> int:
    """Modeled device bytes of the matrix-path A payload under ``fmt``."""
    if fmt == "nm":
        n_pat, m_pat = nm_pattern
        gk = bk // m_pat
        # packed fp32 values (n per group) + int32 position codes (1/group)
        return num_steps * bm * gk * (n_pat + 1) * 4
    if fmt == "bitmap":
        words = (bk + 31) // 32
        return num_steps * bm * (words + row_cap) * 4
    return num_steps * bm * bk * 4


def select_matrix_format(
    *, nm_pattern: Optional[tuple], tile_zero_fraction: float,
    num_steps: int, bm: int, bk: int, row_cap: int,
    hint=None,
) -> str:
    """Pick the matrix-path payload format: general | nm | bitmap.

    Explicit hints (``("nm", n, m)`` / ``"bitmap"``) override pricing; the
    soft ``"nm"`` hint takes any detected pattern.  Unhinted selection
    promotes only a *detected* N:M pattern with a substantial modeled-bytes
    saving, never the bitmap payload.
    """
    if isinstance(hint, tuple) and hint and hint[0] == "nm":
        return "nm"
    general = matrix_payload_bytes("general", num_steps, bm, bk)
    if hint == "bitmap":
        bitmap_bytes = matrix_payload_bytes(
            "bitmap", num_steps, bm, bk, row_cap=row_cap
        )
        return "bitmap" if bitmap_bytes <= general else "general"
    if nm_pattern is not None:
        nm_bytes = matrix_payload_bytes(
            "nm", num_steps, bm, bk, nm_pattern=nm_pattern
        )
        if hint == "nm" or nm_bytes <= STRUCTURED_BYTES_HYSTERESIS * general:
            return "nm"
    return "general"


# --- vector-path (fringe) dispatch tiers -------------------------------------
# The reference's budget: 12 MB of the TPU's 16 MB VMEM.
FRINGE_VMEM_BUDGET = 12 * 1024 * 1024
FRINGE_MIN_BK = SUBLANES  # smallest legal fp32 k-slice (sublane multiple)


def _pad_rows(num_rows: int) -> int:
    """Packed fringe rows padded to the fp32 sublane multiple."""
    return max(SUBLANES, ((num_rows + SUBLANES - 1) // SUBLANES) * SUBLANES)


def fringe_resident_bytes(k: int, num_rows: int, bn: int) -> int:
    """Resident-tier working set: full (K, bn) B panel + packed out block."""
    return (k + _pad_rows(num_rows)) * bn * 4


def fringe_ksharded_bytes(bk: int, num_rows: int, bn: int) -> int:
    """Streaming-tier working set: double-buffered (bk, bn) B slice + out."""
    return (2 * bk + _pad_rows(num_rows)) * bn * 4


def ksharded_bk_cap(k: int, num_rows: int, bn: int, budget: int) -> int:
    """Largest legal ``bk`` for the K-sharded fringe tier, or 0 if none.

    Two clamps: the double-buffered (bk, bn) slice pair plus the packed
    output block must fit ``budget`` bytes, and streaming must be strictly
    cheaper in bytes than the resident panel (``2*bk < k``).  The result is
    a sublane multiple; candidates below ``FRINGE_MIN_BK`` collapse to 0.
    """
    bk_budget = (int(budget) // (bn * 4) - _pad_rows(num_rows)) // 2
    bk_superior = (int(k) - 1) // 2  # strictly cheaper in bytes: 2*bk < k
    bk = (min(bk_budget, bk_superior) // SUBLANES) * SUBLANES
    return int(bk) if bk >= FRINGE_MIN_BK else 0


def select_fringe_tier(
    k: int, num_rows: int, bn: int, vmem_budget: Optional[int] = None,
    impl: str = "torch",
) -> tuple:
    """Pick the vector-path kernel tier for a fringe of this shape.

    Returns ``(tier, bk)``, decided by the reference's VMEM arithmetic:

    - ``("resident", 0)``  — the whole (K, bn) B panel fits the budget;
    - ``("ksharded", bk)`` — a (bk, bn) slice stream fits, bk from
      :func:`ksharded_bk_cap`;
    - ``("xla", 0)``       — nothing fits.

    H100 tier rule: when that arithmetic returns ``"xla"`` and ``impl ==
    "cuda"``, the answer is ``("resident", 0)``.  On the TPU "xla" means
    "no kernel can hold this panel in VMEM"; on Hopper the resident-tier
    kernel is a row-sorted gather that streams B rows through L2 and owns
    disjoint output rows, so it has no panel-size ceiling and a realistic
    fringe must not run kernel-less.  Every other outcome, and every
    ``impl == "torch"`` outcome, is the reference's.
    """
    budget = FRINGE_VMEM_BUDGET if vmem_budget is None else int(vmem_budget)
    if fringe_resident_bytes(k, num_rows, bn) <= budget:
        return "resident", 0
    bk = ksharded_bk_cap(k, num_rows, bn, budget)
    if bk:
        return "ksharded", bk
    if impl == "cuda":
        return "resident", 0
    return "xla", 0


# --- SDDMM dispatch tiers ----------------------------------------------------
# The reference's SDDMM fringe gather keeps both dense operand panels, X and
# Y^T, resident in VMEM; its choice is binary: the resident gather kernel or
# the kernel-less "xla" gather.


def sddmm_resident_bytes(d: int, n_src_rows: int, n_dst_rows: int,
                         chunk: int = 64) -> int:
    """SDDMM gather working set: X panel + Y^T panel + one output chunk."""
    return (_pad_rows(n_src_rows) + _pad_rows(n_dst_rows)) * d * 4 + \
        _pad_rows(chunk) * VPU_LANES * 4


def select_sddmm_tier(
    d: int, n_src_rows: int, n_dst_rows: int,
    vmem_budget: Optional[int] = None, impl: str = "torch",
) -> str:
    """Pick the SDDMM fringe-gather tier: ``"resident"`` or ``"xla"``.

    H100 SDDMM tier rule: where the reference's arithmetic returns "xla"
    and ``impl == "cuda"``, the answer is "resident".  The card's gather
    kernel reads X and Y^T rows through L2 and has no panel-size ceiling,
    so no fringe nonzero falls to a plain version on the card (the same
    reasoning as :func:`select_fringe_tier`).  ``impl == "torch"`` keeps
    the reference's answer.
    """
    budget = FRINGE_VMEM_BUDGET if vmem_budget is None else int(vmem_budget)
    if sddmm_resident_bytes(d, n_src_rows, n_dst_rows) <= budget:
        return "resident"
    if impl == "cuda":
        return "resident"
    return "xla"


# --- data-parallel shard-axis selection -------------------------------------
# A sharded executor can distribute work two ways: shard output row-windows
# (plan state fully distributed; balance limited by how evenly window costs
# split) or replicate the plan and shard RHS columns (perfectly balanced by
# construction; plan memory replicated per device).  The estimator prices
# both and picks per plan.  Host code, as in the reference; the port's
# sharded executor is a later ROADMAP item.
ROWS_IMBALANCE_THRESHOLD = 1.25  # max tolerated LPT max/mean before rhs wins


@dataclasses.dataclass(frozen=True)
class ShardAxisDecision:
    shard_axis: str        # "rows" | "rhs"
    n_shards: int
    rows_imbalance: float  # predicted max/mean load of the LPT row split
    reason: str


def select_shard_axis(
    window_costs: np.ndarray,
    n_shards: int,
    imbalance_threshold: float = ROWS_IMBALANCE_THRESHOLD,
) -> ShardAxisDecision:
    """Pick the data-parallel axis for a plan with these window costs.

    Runs the LPT assignment (coordinator.balance_row_window_list) the
    rows-sharded executor would use and measures its max/mean load;
    row-sharding wins unless the distribution is skewed past the threshold
    or there are too few costed windows to occupy every shard.
    """
    from .coordinator import balance_row_window_list, list_imbalance

    wc = np.asarray(window_costs, np.float64)
    n_shards = int(n_shards)
    if n_shards <= 1:
        return ShardAxisDecision("rows", n_shards, 1.0, "single shard")
    active = int(np.count_nonzero(wc))
    if active == 0:
        # empty matrix: nothing to balance, and rows has no N-divisibility
        # constraint, so the degenerate case stays on the unconstrained axis
        return ShardAxisDecision("rows", n_shards, 1.0, "no costed windows")
    if active < n_shards:
        return ShardAxisDecision(
            "rhs", n_shards, float("inf"),
            f"{active} non-empty windows < {n_shards} shards",
        )
    assignment = balance_row_window_list(wc, n_shards)
    imb = list_imbalance(assignment, wc)
    if imb > imbalance_threshold:
        return ShardAxisDecision(
            "rhs", n_shards, float(imb),
            f"LPT row imbalance {imb:.2f} > {imbalance_threshold:.2f}",
        )
    return ShardAxisDecision(
        "rows", n_shards, float(imb), f"LPT row imbalance {imb:.2f}"
    )
