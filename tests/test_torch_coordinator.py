"""repro_torch.core.coordinator against repro.core.coordinator.

The first four tests mirror ``tests/test_coordinator.py`` on the port
(adaptive coordination, paper §5.3, and row-window balancing, paper §7).
The parity test feeds the same numpy inputs, made from a seed, to both
packages and asserts equal results: the coordinator is host code on numpy
in both, so histories, assignments, window costs and shard decisions are
compared exactly (no tolerance).
"""
import dataclasses

import numpy as np
import pytest
from _hyp import given, settings, st

from repro_torch.core.coordinator import (
    AdaptiveCoordinator, balance_row_window_list, list_imbalance,
    window_costs_from_coo,
)
from repro_torch.core.cost_model import (
    EngineCostModel, default_cost_model, select_shard_axis,
)

# held against the JAX package: skip where it is not installed
jax_coord = pytest.importorskip("repro.core.coordinator")
jax_cost = pytest.importorskip("repro.core.cost_model")


def _simulate(coord, cm, max_epochs=30):
    for _ in range(max_epochs):
        st_ = coord.state
        t_m = cm.cost_matrix(max(st_.matrix_rows, 1), st_.k)
        t_v = cm.cost_vector(max(st_.vector_nnz, 1))
        coord.observe(t_m, t_v)
        if coord.converged():
            break
    return coord


def test_converges_from_extreme_skew_within_7_rounds():
    """Paper Fig. 18: bisection-style convergence, <=7 rounds from extremes."""
    rng = np.random.RandomState(0)
    cm = EngineCostModel(p_matrix=1e9, p_vector=5e6, r=1.0)
    nw = 200
    nnz = rng.randint(10, 2000, nw).astype(float)
    rows = np.full(nw, 128.0)
    for init in (np.ones(nw, bool), np.zeros(nw, bool)):
        coord = AdaptiveCoordinator(cm, nnz, rows, init.copy(), k=4096)
        _simulate(coord, cm)
        r = coord.rounds_to_converge()
        assert r is not None and r <= 7, r


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 50), pm=st.floats(1e8, 1e10),
       pv=st.floats(1e5, 1e7))
def test_skew_never_increases_limit(seed, pm, pv):
    """Property: after convergence the skew stays within tolerance."""
    rng = np.random.RandomState(seed)
    cm = EngineCostModel(p_matrix=pm, p_vector=pv, r=1.0)
    nw = 100
    nnz = rng.randint(1, 3000, nw).astype(float)
    rows = np.full(nw, 64.0)
    coord = AdaptiveCoordinator(cm, nnz, rows, rng.rand(nw) < 0.5, k=2048)
    _simulate(coord, cm, max_epochs=40)
    if coord.converged():
        final = coord.history[-1].skew
        assert final <= 1.0 + coord.epsilon + 1e-9


def test_no_migration_when_balanced():
    cm = EngineCostModel(p_matrix=1.0, p_vector=1.0)
    coord = AdaptiveCoordinator(
        cm, np.ones(10), np.ones(10), np.zeros(10, bool), k=10)
    rec = coord.observe(1.0, 1.01)
    assert rec.migrated_windows == 0


def test_lpt_balances_power_law_windows():
    rng = np.random.RandomState(0)
    costs = rng.pareto(1.1, 500) + 0.1
    naive = [np.arange(i, 500, 24) for i in range(24)]
    lpt = balance_row_window_list(costs, 24)
    assert list_imbalance(lpt, costs) < list_imbalance(naive, costs)
    # LPT is within ~4/3 of the lower bound max(ideal, heaviest window)
    lower = max(1.0, costs.max() / (costs.sum() / 24))
    assert list_imbalance(lpt, costs) <= lower * 4 / 3 + 1e-9
    # every window assigned exactly once
    allw = np.concatenate(lpt)
    assert sorted(allw.tolist()) == list(range(500))


def _both_models(pm, pv):
    return (EngineCostModel(p_matrix=pm, p_vector=pv),
            jax_cost.EngineCostModel(p_matrix=pm, p_vector=pv))


def _observe_both(seed, init, max_epochs=30):
    """The same simulated epochs through both coordinators; the times each
    observes come from its own state, so a divergence shows at once."""
    rng = np.random.RandomState(seed)
    pm, pv = 10 ** rng.uniform(8, 10), 10 ** rng.uniform(5, 7)
    nw = 80
    nnz = rng.randint(1, 3000, nw).astype(float)
    rows = rng.randint(16, 129, nw).astype(float)
    on_vec = {"all": np.ones(nw, bool), "none": np.zeros(nw, bool),
              "random": rng.rand(nw) < 0.5}[init]
    out = []
    for coord_mod, cm in zip((None, jax_coord), _both_models(pm, pv)):
        cls = AdaptiveCoordinator if coord_mod is None else (
            coord_mod.AdaptiveCoordinator)
        coord = cls(cm, nnz, rows, on_vec, k=2048)
        _simulate(coord, cm, max_epochs=max_epochs)
        out.append(coord)
    return out


@pytest.mark.parametrize("case", [
    "observe-all", "observe-none", "observe-random", "lpt", "window-costs",
    "window-costs-alpha", "shard-axis",
])
@pytest.mark.parametrize("seed", [0, 7])
def test_coordinator_matches_reference(case, seed):
    if case.startswith("observe-"):
        ours, theirs = _observe_both(seed, case.split("-")[1])
        assert [dataclasses.astuple(r) for r in ours.history] == [
            dataclasses.astuple(r) for r in theirs.history]
        assert np.array_equal(ours.state.on_vector, theirs.state.on_vector)
        assert ours.converged() == theirs.converged()
        assert ours.rounds_to_converge() == theirs.rounds_to_converge()
        return
    rng = np.random.RandomState(seed)
    if case == "lpt":
        costs = rng.pareto(1.1, 300) + 0.1
        for n_cores in (1, 5, 24):
            ours = balance_row_window_list(costs, n_cores)
            theirs = jax_coord.balance_row_window_list(costs, n_cores)
            assert [a.tolist() for a in ours] == [a.tolist() for a in theirs]
            assert list_imbalance(ours, costs) == jax_coord.list_imbalance(
                theirs, costs)
        return
    m, k, bm = 1000, 700, 128
    rows = rng.randint(0, m, 5000)
    rows[:800] = 3      # one heavy row: its window prices as matrix work
    ours_cm, theirs_cm = (default_cost_model(256),
                          jax_cost.default_cost_model(256))
    alpha = 0.02 if case == "window-costs-alpha" else None
    wc_ours = window_costs_from_coo(rows, m, bm, k, ours_cm, alpha=alpha)
    wc_theirs = jax_coord.window_costs_from_coo(rows, m, bm, k, theirs_cm,
                                                alpha=alpha)
    assert np.array_equal(wc_ours, wc_theirs)
    if case == "shard-axis":
        for costs in (wc_ours, rng.pareto(1.1, 64) + 0.1,
                      np.zeros(8), np.array([5.0, 0, 0, 1.0])):
            for n_shards in (1, 2, 4, 8):
                ours = select_shard_axis(costs, n_shards)
                theirs = jax_cost.select_shard_axis(costs, n_shards)
                assert dataclasses.astuple(ours) == dataclasses.astuple(
                    theirs)
        assert (default_cost_model().imbalance_threshold()
                == jax_cost.default_cost_model().imbalance_threshold())
