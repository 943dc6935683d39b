"""Adaptive AIV-AIC coordinated pipelining (paper §5.3) + row-window list
balancing (paper §7), engine-agnostic.

The coordinator observes per-epoch wall-clock of the two streams, computes
the Skew ratio (Eq. 6), and when Skew > 1 + eps migrates work toward the
alpha-target split (Eq. 7).  Migration granularity is a row-window for the
matrix path and a row-group for the vector path, matching the paper.  The
procedure behaves like bisection on the residual imbalance, so convergence
rounds grow logarithmically with the initial skew (validated in tests and
in the Fig. 18 benchmark).

A copy of ``repro.core.coordinator``, priced with the port's own
:class:`~repro_torch.core.cost_model.EngineCostModel`: host code on numpy,
giving the reference's results exactly.  ``exec.api.NeutronSpMM``'s
epoch loop takes its Eq. 6 skew from here, and
``cost_model.select_shard_axis`` prices shards with its LPT helpers.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cost_model import EngineCostModel


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    t_matrix: float
    t_vector: float
    skew: float
    migrated_windows: int  # + = matrix->vector, - = vector->matrix
    vector_nnz_fraction: float


@dataclasses.dataclass
class CoordinatorState:
    """Work ledger: which windows run on which stream.

    ``window_nnz[w]``/``window_rows[w]`` describe window w; densities are
    recorded during local reordering (paper: "we simultaneously record the
    sparsity of each tile").
    """

    window_nnz: np.ndarray
    window_rows: np.ndarray
    on_vector: np.ndarray  # bool per window
    k: int

    @property
    def vector_nnz(self) -> float:
        return float(self.window_nnz[self.on_vector].sum())

    @property
    def matrix_rows(self) -> float:
        return float(self.window_rows[~self.on_vector].sum())

    @property
    def vector_nnz_fraction(self) -> float:
        tot = float(self.window_nnz.sum())
        return self.vector_nnz / tot if tot else 0.0


class AdaptiveCoordinator:
    """Epoch-granular monitor + migrator."""

    def __init__(
        self,
        cost_model: EngineCostModel,
        window_nnz: np.ndarray,
        window_rows: np.ndarray,
        initial_on_vector: np.ndarray,
        k: int,
        epsilon: float = 0.05,
        max_migration_frac: float = 0.5,
    ):
        self.cost_model = cost_model
        self.state = CoordinatorState(
            window_nnz=np.asarray(window_nnz, np.float64),
            window_rows=np.asarray(window_rows, np.float64),
            on_vector=np.asarray(initial_on_vector, bool).copy(),
            k=int(k),
        )
        self.epsilon = float(epsilon)
        self.max_migration_frac = float(max_migration_frac)
        self.history: List[EpochRecord] = []

    # -- Eq. 6 --
    @staticmethod
    def skew(t_matrix: float, t_vector: float) -> float:
        hi = max(t_matrix, t_vector)
        lo = max(min(t_matrix, t_vector), 1e-12)
        return hi / lo

    def observe(self, t_matrix: float, t_vector: float) -> EpochRecord:
        """Record an epoch; migrate if imbalanced.  Returns the record."""
        s = self.skew(t_matrix, t_vector)
        migrated = 0
        if s > 1.0 + self.epsilon:
            if t_matrix > t_vector:
                migrated = self._migrate_matrix_to_vector(t_matrix, t_vector)
            else:
                migrated = -self._migrate_vector_to_matrix(t_matrix, t_vector)
        rec = EpochRecord(
            epoch=len(self.history),
            t_matrix=t_matrix,
            t_vector=t_vector,
            skew=s,
            migrated_windows=migrated,
            vector_nnz_fraction=self.state.vector_nnz_fraction,
        )
        self.history.append(rec)
        return rec

    # -- Eq. 7: move sparsest matrix windows until predicted finish balances --
    def _migrate_matrix_to_vector(self, t_m: float, t_v: float) -> int:
        st = self.state
        cand = np.flatnonzero(~st.on_vector)
        if cand.size == 0:
            return 0
        dens = st.window_nnz[cand] / np.maximum(st.window_rows[cand] * st.k, 1.0)
        cand = cand[np.argsort(dens, kind="stable")]  # sparsest first (paper rule)
        # moving a window sheds `gain` from the slow engine and adds `cost` to
        # the fast one, so the finish-time gap shrinks by gain + cost
        excess = t_m - t_v
        per_row_cost = t_m / max(st.matrix_rows, 1.0)
        per_nnz_vcost = t_v / max(st.vector_nnz, 1.0) if st.vector_nnz else (
            1.0 / self.cost_model.p_vector
        )
        moved = 0
        budget = int(max(1, self.max_migration_frac * cand.size))
        for w in cand[:budget]:
            gain = st.window_rows[w] * per_row_cost
            cost = st.window_nnz[w] * per_nnz_vcost
            delta = gain + cost
            if delta > excess:  # moving would overshoot more than it helps
                break
            st.on_vector[w] = True
            excess -= delta
            moved += 1
        return moved

    # -- densify: move densest vector windows back to the matrix path --
    def _migrate_vector_to_matrix(self, t_m: float, t_v: float) -> int:
        st = self.state
        cand = np.flatnonzero(st.on_vector)
        if cand.size == 0:
            return 0
        dens = st.window_nnz[cand] / np.maximum(st.window_rows[cand] * st.k, 1.0)
        cand = cand[np.argsort(-dens, kind="stable")]  # densest first (paper rule)
        excess = t_v - t_m
        per_nnz_vcost = t_v / max(st.vector_nnz, 1.0)
        per_row_mcost = t_m / max(st.matrix_rows, 1.0) if st.matrix_rows else (
            st.k / self.cost_model.p_matrix
        )
        moved = 0
        budget = int(max(1, self.max_migration_frac * cand.size))
        for w in cand[:budget]:
            gain = st.window_nnz[w] * per_nnz_vcost
            cost = st.window_rows[w] * per_row_mcost
            delta = gain + cost
            if delta > excess:
                break
            st.on_vector[w] = False
            excess -= delta
            moved += 1
        return moved

    def converged(self) -> bool:
        return bool(self.history) and self.history[-1].skew <= 1.0 + self.epsilon

    def rounds_to_converge(self) -> Optional[int]:
        for rec in self.history:
            if rec.skew <= 1.0 + self.epsilon:
                return rec.epoch
        return None


def window_costs_from_coo(
    rows: np.ndarray, m: int, bm: int, k: int, cost_model: EngineCostModel,
    alpha: Optional[float] = None,
) -> np.ndarray:
    """Per-row-window cost estimate straight from raw COO (pre-``prepare``).

    Window w covers original rows [w*bm, (w+1)*bm).  Each window is costed
    by the engine the cost-model split would route it to — vector cost
    (∝ nnz, Eq. 1) below the alpha density boundary, matrix cost (∝ rows*K)
    above — so the same model that balances the two intra-chip paths prices
    inter-device shards.  ``alpha`` overrides the model's Eq. 3 boundary the
    same way ``SpmmConfig.alpha`` overrides it in ``prepare`` — callers with
    a forced split must price windows by the engine that will actually run
    them.  Feed the result to :func:`balance_row_window_list` for the LPT
    shard assignment.
    """
    nw = (m + bm - 1) // bm
    if nw == 0:
        return np.zeros(0, np.float64)
    a = cost_model.alpha if alpha is None else float(alpha)
    rows = np.asarray(rows, np.int64)
    nnz_w = np.bincount(rows // bm, minlength=nw).astype(np.float64)
    rows_w = np.minimum(np.arange(1, nw + 1) * bm, m) - np.arange(nw) * bm
    dens = nnz_w / np.maximum(rows_w * max(k, 1), 1.0)
    cost_v = cost_model.cost_vector(nnz_w)
    cost_m = cost_model.cost_matrix(rows_w.astype(np.float64), max(k, 1))
    return np.where(dens <= a, cost_v, cost_m)


def balance_row_window_list(
    window_costs: Sequence[float], n_cores: int
) -> List[np.ndarray]:
    """Row-window list migration (paper §7): interleave heavy and light
    windows across cores without splitting windows.  Greedy LPT assignment;
    returns per-core window-id lists."""
    costs = np.asarray(window_costs, np.float64)
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_cores)
    lists: List[List[int]] = [[] for _ in range(n_cores)]
    for w in order:
        c = int(np.argmin(loads))
        lists[c].append(int(w))
        loads[c] += costs[w]
    return [np.asarray(l, np.int64) for l in lists]


def list_imbalance(assignment: List[np.ndarray], window_costs: Sequence[float]) -> float:
    """max/mean per-core load (1.0 = perfectly balanced)."""
    costs = np.asarray(window_costs, np.float64)
    loads = np.asarray([costs[a].sum() for a in assignment])
    mean = loads.mean() if loads.size else 1.0
    return float(loads.max() / max(mean, 1e-12))
