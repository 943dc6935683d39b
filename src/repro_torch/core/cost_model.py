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
:func:`select_fringe_tier` and :func:`select_sddmm_tier`, and the H100
split below.

Three calibrations: ``analytic_tpu`` derives the rates from the
reference's roofline constants (the reference's split, which ``"torch"``
plans keep); ``analytic_h100`` takes them from the card's own kernels,
measured once (the split of ``"cuda"`` plans: ``core.tuner`` resolves it);
and ``measure`` times the two paths on the current device through the
synchronised ``tuner.timed_best_of`` (the paper's microbenchmark dry run).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

# The reference's TPU constants, kept so that plan leaves match the JAX
# package's (the reference's split threshold, reuse capacities and fringe
# tiers are all derived from them).  They do not describe the H100.
PEAK_FLOPS_BF16 = 197e12  # per chip
HBM_BW = 819e9  # bytes/s
ICI_BW = 50e9  # bytes/s/link
VMEM_BYTES = 16 * 1024 * 1024
MXU_DIM = 128  # systolic array edge; min efficient tile
VPU_LANES = 128
SUBLANES = 8

# The card's ceilings, from NVIDIA's data sheet for the H100 SXM at its
# 700 W limit: HBM3 bandwidth and the fp32 rate outside the tensor cores.
# The telemetry roofline (``obs.report``) prices dispatches against them.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12

# The split's rates on the H100 80GB HBM3 at 700 W, N = H100_RATE_N, from
# bench_torch/split_rates.py (PERF.md §6): B1 (dense_tile_spmm)
# seconds for one bm x bk = 128 x 64 tile on each of its tiers, B read
# from HBM, and the fringe row walk's (B2/B3) nonzeros a second.  B1 picks
# the tier per tile by its density (kMmaMinDensity in
# kernels/csrc/tile_core.cuh).  The walk's rate is the one on ogbn-arxiv's
# whole matrix, long rows included: the split decides about long rows,
# and the walk takes them at about that rate (Reddit's rows above 10 k
# nonzeros: 2.2e9-3.7e9 a second), its short rows at 8e9.
H100_RATE_N = 256
H100_TILE_CELLS = 128 * 64
H100_TILE_WALK_S = 38.78e-9     # a tile on the zero-skipping walk ...
H100_TILE_WALK_NNZ_S = 0.190e-9  # ... and each nonzero it holds
H100_TILE_MMA_S = 109.87e-9      # a tile on the 3xTF32 product
H100_MMA_MIN_DENSITY = 0.05      # kMmaMinDensity
H100_WALK_NNZ_PER_S = 3.431e9


@dataclasses.dataclass
class EngineCostModel:
    """Predicts per-path execution cost and the split threshold alpha."""

    p_matrix: float  # matrix-path rate: dense tile elements / second
    p_vector: float  # vector-path rate: nonzeros / second
    r: float = 1.0   # capacity ratio (paper's r; engine-count analogue)
    n_cols: int = 256  # dense operand width N the rates were calibrated for
    # whether the model prices B1's tiles by the H100_* constants
    # (``analytic_h100``), and so each core window as B1 runs it
    prices_tiles: bool = False

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
    def analytic_h100(cls, r: float = 1.0) -> "EngineCostModel":
        """The card's own rates at N = ``H100_RATE_N``: B1 per tile and the
        row walk per nonzero.

        ``p_matrix`` is B1's tile cells a second on its 3xTF32 tier;
        ``p_vector`` is the row walk's nonzeros a second.  Their alpha
        (0.046) is the density at which a tile costs B1 what its nonzeros
        cost the walk, on either of B1's tiers (they cross there).
        """
        return cls(p_matrix=H100_TILE_CELLS / H100_TILE_MMA_S,
                   p_vector=H100_WALK_NNZ_PER_S, r=r, n_cols=H100_RATE_N,
                   prices_tiles=True)

    @staticmethod
    def tile_seconds(tile_nnz: np.ndarray, cells: int) -> np.ndarray:
        """B1's seconds for ``cells``-cell tiles holding these nonzeros:
        the 3xTF32 product at or above ``H100_MMA_MIN_DENSITY``, else the
        zero-skipping walk."""
        nnz = np.asarray(tile_nnz, np.float64)
        per_tile = cells / H100_TILE_CELLS
        walk = H100_TILE_WALK_S * per_tile + H100_TILE_WALK_NNZ_S * nnz
        return np.where(nnz >= H100_MMA_MIN_DENSITY * cells,
                        H100_TILE_MMA_S * per_tile, walk)

    def windows_cheaper_on_walk(
        self, tile_window: np.ndarray, tile_nnz: np.ndarray,
        num_windows: int, cells: int,
    ) -> np.ndarray:
        """Ids of the core windows whose nonzeros the row walk takes in
        less time than B1 takes their padded tiles (none where the model
        prices no tiles).  Both paths run on one stream, so the least sum
        of the two is the goal, not balanced finish times."""
        if not self.prices_tiles or not num_windows:
            return np.zeros(0, np.int64)
        b1 = np.bincount(tile_window, self.tile_seconds(tile_nnz, cells),
                         minlength=num_windows)
        walk = np.bincount(tile_window, np.asarray(tile_nnz, np.float64),
                           minlength=num_windows) / self.p_vector
        return np.flatnonzero(walk < b1)

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

    def select_sddmm_tier(
        self, d: int, n_src_rows: int, n_dst_rows: int,
        vmem_budget: Optional[int] = None, impl: str = "torch",
    ) -> str:
        return select_sddmm_tier(d, n_src_rows, n_dst_rows,
                                 vmem_budget=vmem_budget, impl=impl)

    def imbalance_threshold(self) -> float:
        """Max tolerated LPT row imbalance before rhs-sharding wins."""
        return ROWS_IMBALANCE_THRESHOLD

    def compaction_thresholds(self) -> tuple:
        """``(max_delta_fraction, max_slowdown)`` for
        :func:`should_compact`."""
        return DELTA_MAX_FRACTION, DELTA_MAX_SLOWDOWN

    def densify_occupancy(self) -> Optional[float]:
        """Occupancy above which the reference's core densifies (None: its
        kernel default).  No executor of the port reads it: B1 has no
        densify crossover (``kMmaMinDensity`` in ``csrc/tile_core.cuh``
        picks the tile product instead)."""
        return None

    def tile_shape(self, m: int, k: int, n: int,
                   nnz: int) -> Optional[tuple]:
        """Autotuned ``(bm, bk)`` for this problem, or None to keep the
        config's.  The analytic model never overrides; only the measured
        table (``core.tuner.TunedCostModel``) answers."""
        return None

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
# both and picks per plan.  Host code, as in the reference.
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


# --- dynamic-delta compaction policy ----------------------------------------
# Structural mutations accumulate in a COO sidecar run on the vector path
# (dynamic/delta.py).  A small delta belongs there; once it grows past a
# fraction of the base matrix, or its predicted vector-path cost would
# dominate the plan's own, folding it into a fresh prepare wins back the
# coordinated split.  The reference's policy and thresholds, unchanged: the
# same engine rates that price the split price this trigger.
DELTA_MAX_FRACTION = 0.25   # delta nnz / base nnz before a forced fold
DELTA_MAX_SLOWDOWN = 1.25   # predicted (base+delta)/base exec cost ratio
# denominator floor for the fraction trigger: a plan built (near-)empty and
# grown by inserts would otherwise fold on its first batches
DELTA_BASE_NNZ_FLOOR = 256


@dataclasses.dataclass(frozen=True)
class CompactionDecision:
    compact: bool
    delta_fraction: float   # delta nnz / base nnz
    est_slowdown: float     # predicted exec-cost ratio with the sidecar
    reason: str


def should_compact(
    cm: EngineCostModel,
    *,
    base_nnz: int,
    delta_nnz: int,
    core_rows: int,
    fringe_nnz: int,
    k: int,
    max_delta_fraction: float = DELTA_MAX_FRACTION,
    max_slowdown: float = DELTA_MAX_SLOWDOWN,
) -> CompactionDecision:
    """Decide whether a delta sidecar should fold into a fresh plan.

    ``core_rows`` is the matrix path's packed row count (num_windows * bm)
    and ``fringe_nnz`` the base plan's vector-path nonzeros; together they
    price the base execution the sidecar rides on.  A base with no cost
    (an empty plan) folds on the fraction trigger alone, its denominator
    floored at ``DELTA_BASE_NNZ_FLOOR``.
    """
    fraction = delta_nnz / max(base_nnz, DELTA_BASE_NNZ_FLOOR)
    base_cost = cm.cost_matrix(core_rows, k) + cm.cost_vector(fringe_nnz)
    if delta_nnz == 0:
        return CompactionDecision(False, 0.0, 1.0, "empty delta")
    if base_cost <= 0.0:
        if fraction > max_delta_fraction:
            return CompactionDecision(
                True, fraction, 1.0,
                f"empty base: delta nnz fraction {fraction:.3f} > "
                f"{max_delta_fraction:.2f} (floored base "
                f"{max(base_nnz, DELTA_BASE_NNZ_FLOOR)})")
        return CompactionDecision(
            False, fraction, 1.0,
            f"empty base: delta within floored fraction budget "
            f"({fraction:.3f})")
    slowdown = (base_cost + cm.cost_vector(delta_nnz)) / base_cost
    if fraction > max_delta_fraction:
        return CompactionDecision(
            True, fraction, slowdown,
            f"delta nnz fraction {fraction:.3f} > {max_delta_fraction:.2f}")
    if slowdown > max_slowdown:
        return CompactionDecision(
            True, fraction, slowdown,
            f"predicted fringe-path slowdown {slowdown:.2f} > "
            f"{max_slowdown:.2f}")
    return CompactionDecision(
        False, fraction, slowdown,
        f"delta within budget ({fraction:.3f}, {slowdown:.2f})")
