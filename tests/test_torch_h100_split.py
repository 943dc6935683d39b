"""The engine split of ``impl="cuda"`` plans, priced with the H100's rates.

``core.tuner`` resolves ``EngineCostModel.analytic_h100`` for a ``"cuda"``
config and the reference's ``analytic_tpu`` for every other.  The card's
model splits rows by its own alpha (B1's 3xTF32 tile against the row
walk's nonzeros) and then prices every core window as B1 runs it: padded
tiles against the walk, the cheaper path taking the window.  An explicit
``alpha`` and the structured lane keep the reference's split.  Plans are
built on the CPU (``build_plan_arrays`` runs no kernel); the products run
the plain versions (``impl="torch"`` with the card's model passed in) and
are held against float64.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import spmm, tuner
from repro_torch.core.cost_model import EngineCostModel, default_cost_model
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig
from repro_torch.examples.gcn_training import make_graph
from repro_torch.exec import api

TOL = 1e-5
_TIMINGS = ("t_partition_s", "t_reorder_s", "t_pack_s")
H100 = EngineCostModel.analytic_h100()
CELLS = 128 * 64


def _low_alpha(alpha):
    """The card's model with its row stage moved to ``alpha`` (the tiles
    and the walk priced as measured)."""
    return dataclasses.replace(H100, p_matrix=H100.p_vector / alpha)


def _stats(meta):
    return {k: v for k, v in meta["stats"] if k not in _TIMINGS}


def _same_leaves(a, b):
    for name in LEAF_NAMES:
        assert a[name].dtype == b[name].dtype, name
        assert np.array_equal(a[name], b[name]), name


def _product_close(rows, cols, vals, shape, plan, n=16, seed=0):
    """``execute`` on the CPU against the float64 product, row by row."""
    b = np.random.RandomState(seed).randn(shape[1], n).astype(np.float32)
    want = np.zeros((shape[0], n))
    np.add.at(want, rows, np.asarray(vals, np.float64)[:, None]
              * b.astype(np.float64)[cols])
    got = api.execute(plan, torch.from_numpy(b)).numpy().astype(np.float64)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def chung_lu(n, avg_degree, skew, seed):
    """A symmetric Chung-Lu graph: weights Pareto(skew) + 1 scaled to a
    mean of ``avg_degree`` and capped at n, both ends of an edge drawn in
    proportion to them, no self-loops (the Reddit configuration's law)."""
    rng = np.random.RandomState(seed)
    w = rng.pareto(skew, n) + 1.0
    w = np.minimum(w / w.mean() * avg_degree, n)
    p = w / w.sum()
    u = rng.choice(n, int(n * avg_degree / 2), p=p)
    v = rng.choice(n, u.size, p=p)
    keep = u != v
    key = np.unique(np.concatenate([u[keep] * n + v[keep],
                                    v[keep] * n + u[keep]]))
    rows, cols = key // n, key % n
    return rows, cols, rng.randn(rows.size).astype(np.float32), (n, n)


@pytest.fixture(scope="module")
def arxiv():
    """The benchmark's ogbn-arxiv graph: max row 5,441 nonzeros."""
    rows, cols, vals, _, _, _ = make_graph(
        n=169343, avg_deg=3.6, n_classes=40, seed=0, symmetric=True)
    return rows, cols, vals, (169343, 169343)


def nm_coo(rng, m, k, n_pat, m_pat):
    """Exact N:M COO: n_pat nonzeros in every m_pat-wide group of a row."""
    gk = k // m_pat
    top = np.argsort(rng.rand(m, gk, m_pat), axis=2)[:, :, :n_pat]
    rows = np.repeat(np.arange(m), gk * n_pat)
    base = np.broadcast_to(np.arange(gk)[None, :, None] * m_pat, top.shape)
    cols = (base + top).reshape(-1)
    vals = rng.randn(rows.size).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("bn", [128, 256])
def test_resolve_gives_the_card_model_to_cuda_only(bn):
    def resolve(impl):
        return tuner.resolve_cost_model("spmm", 500, 400, 2000,
                                        SpmmConfig(impl=impl, bn=bn))

    assert resolve("cuda") == EngineCostModel.analytic_h100()
    assert resolve("torch") == default_cost_model(n_cols=bn)
    assert resolve("cuda").prices_tiles
    assert not resolve("torch").prices_tiles


def test_alpha_is_the_break_even_of_b1_and_the_walk():
    """At the row stage's density a tile costs B1 (on either tier) about
    what its nonzeros cost the walk; sparser tiles are cheaper on the
    walk, denser ones on B1."""
    a = H100.alpha
    # a dense tile (the 3xTF32 tier) and a tile at alpha (the walk's)
    for tile_nnz in (CELLS, a * CELLS):
        tile_s = float(H100.tile_seconds(np.array([tile_nnz]), CELLS)[0])
        assert tile_s == pytest.approx(a * CELLS / H100.p_vector, rel=0.02)
    nnz = np.arange(CELLS + 1)
    cheaper_on_b1 = H100.tile_seconds(nnz, CELLS) < nnz / H100.p_vector
    assert not cheaper_on_b1[nnz < 0.98 * a * CELLS].any()
    assert cheaper_on_b1[nnz > 1.02 * a * CELLS].all()


def test_windows_cheaper_on_walk_sums_each_windows_tiles():
    # window 0: two dense tiles; window 1: one sparse tile; window 2: none
    tile_window = np.array([0, 0, 1])
    tile_nnz = np.array([CELLS // 2, CELLS // 4, 20])
    moved = H100.windows_cheaper_on_walk(tile_window, tile_nnz, 3, CELLS)
    assert moved.tolist() == [1]
    assert default_cost_model().windows_cheaper_on_walk(
        tile_window, tile_nnz, 3, CELLS).size == 0


# --- the split of "cuda" plans ----------------------------------------------


def test_cuda_plan_prices_windows_and_torch_plan_does_not():
    rows, cols, vals, shape = chung_lu(3000, 60, 1.05, seed=1)
    _, meta = spmm.build_plan_arrays(rows, cols, vals, shape,
                                     SpmmConfig(impl="cuda"))
    stats = _stats(meta)
    assert stats["alpha"] == pytest.approx(H100.alpha)
    assert "windows_to_fringe" in stats
    _, meta_t = spmm.build_plan_arrays(rows, cols, vals, shape,
                                       SpmmConfig(impl="torch"))
    assert "windows_to_fringe" not in _stats(meta_t)
    assert _stats(meta_t)["alpha"] == pytest.approx(default_cost_model().alpha)


@pytest.mark.parametrize("alpha", [0.002, 0.03])
def test_explicit_alpha_keeps_the_split_unpriced(alpha, arxiv):
    """An explicit alpha (the user's, or the coordinator's) splits by it
    alone: the card's model gives the leaves the reference's model gives,
    and no window is priced."""
    rows, cols, vals, shape = arxiv
    cfg = SpmmConfig(impl="cuda", alpha=alpha)
    leaves, meta = spmm.build_plan_arrays(rows, cols, vals, shape, cfg)
    ref_leaves, ref_meta = spmm.build_plan_arrays(
        rows, cols, vals, shape, cfg, cost_model=default_cost_model())
    _same_leaves(leaves, ref_leaves)
    assert _stats(meta) == _stats(ref_meta)
    assert "windows_to_fringe" not in _stats(meta)
    assert _stats(meta)["core_nnz"] > 0


def test_arxiv_core_is_empty_at_the_card_alpha(arxiv):
    rows, cols, vals, shape = arxiv
    assert np.bincount(rows).max() == 5441
    _, meta = spmm.build_plan_arrays(rows, cols, vals, shape,
                                     SpmmConfig(impl="cuda"))
    stats = _stats(meta)
    assert stats["core_nnz"] == 0 and stats["num_windows"] == 0
    assert stats["windows_to_fringe"] == 0
    assert stats["fringe_nnz"] == rows.size


def test_heavy_row_window_goes_to_the_fringe(arxiv):
    """At a low alpha the degree-5,441 row alone is core: one window of
    128 padded rows, 1,284 tiles at 0.05 %, which the model prices at
    about 51 us on B1 against 0.7 us on the walk."""
    rows, cols, vals, shape = arxiv
    cfg = SpmmConfig(impl="cuda")
    cm = _low_alpha(0.03)
    _, meta = spmm.build_plan_arrays(rows, cols, vals, shape, cfg,
                                     cost_model=cm)
    stats = _stats(meta)
    assert stats["windows_to_fringe"] == 1
    assert stats["core_nnz"] == 0 and stats["num_windows"] == 0
    # the same row stage without the pricing keeps that window
    _, meta_a = spmm.build_plan_arrays(
        rows, cols, vals, shape, dataclasses.replace(cfg, alpha=cm.alpha))
    assert _stats(meta_a)["num_windows"] == 1
    assert _stats(meta_a)["core_nnz"] == 5441


def test_dense_windows_stay_on_b1():
    """Rows dense enough that their tiles take the product well above the
    break-even stay core through the pricing."""
    rng = np.random.RandomState(5)
    m, k = 600, 512
    a = (rng.rand(m, k) < 0.01) * rng.randn(m, k)
    a[:256] = (rng.rand(256, k) < 0.5) * rng.randn(256, k)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols].astype(np.float32)
    _, meta = spmm.build_plan_arrays(rows, cols, vals, (m, k),
                                     SpmmConfig(impl="cuda"))
    stats = _stats(meta)
    assert stats["windows_to_fringe"] == 0
    assert stats["num_windows"] == 2
    assert stats["tile_density"] > 2 * H100.alpha


# --- the structured lane keeps its tiles --------------------------------------


def _pruned(case):
    """(rows, cols, vals, shape, config overrides, matrix format)."""
    rng = np.random.RandomState(11)
    if case == "2:4-hint":
        return (*nm_coo(rng, 512, 1024, 2, 4), (512, 1024),
                dict(structure_hint=("nm", 2, 4)), "nm")
    if case == "2:4-detected":
        return *nm_coo(rng, 512, 1024, 2, 4), (512, 1024), {}, "nm"
    if case == "1:32-detected":
        return *nm_coo(rng, 512, 1024, 1, 32), (512, 1024), {}, "nm"
    w = (rng.rand(512, 1024) < 0.5) * rng.randn(512, 1024)
    rows, cols = np.nonzero(w)
    vals = w[rows, cols].astype(np.float32)
    if case == "50%-bitmap":
        return rows, cols, vals, (512, 1024), dict(
            structure_hint="bitmap"), "bitmap"
    return rows, cols, vals, (512, 1024), {}, "general"


@pytest.mark.parametrize("case", ["2:4-hint", "2:4-detected",
                                  "1:32-detected", "50%-bitmap",
                                  "50%-general"])
def test_pruned_weights_keep_every_tile_and_their_format(case):
    rows, cols, vals, shape, cfg, fmt = _pruned(case)
    leaves, meta = spmm.build_plan_arrays(rows, cols, vals, shape,
                                          SpmmConfig(impl="cuda", **cfg))
    ref_leaves, ref_meta = spmm.build_plan_arrays(
        rows, cols, vals, shape, SpmmConfig(impl="torch", **cfg))
    assert meta["matrix_format"] == ref_meta["matrix_format"] == fmt
    assert meta["format_params"] == ref_meta["format_params"]
    _same_leaves(leaves, ref_leaves)
    stats, ref_stats = _stats(meta), _stats(ref_meta)
    assert stats["core_nnz"] == ref_stats["core_nnz"] == rows.size
    if fmt == "general":
        # the card's split, which prices the windows and moves none
        assert stats.pop("windows_to_fringe") == 0
        assert stats.pop("alpha") == pytest.approx(H100.alpha)
        ref_stats.pop("alpha")
    assert stats == ref_stats


# --- products of plans split by the card's model -------------------------------


@pytest.mark.parametrize("avg_degree,alpha,has_core", [
    (20, None, False), (60, None, True), (60, 0.01, True),
    (200, None, True), (200, 0.02, True),
])
def test_chung_lu_products_match_float64(avg_degree, alpha, has_core):
    """Every case moves windows to the fringe; some keep a core beside."""
    rows, cols, vals, shape = chung_lu(3000, avg_degree, 1.05, seed=2)
    cm = H100 if alpha is None else _low_alpha(alpha)
    plan = spmm.prepare(rows, cols, vals, shape, SpmmConfig(impl="torch"),
                        cost_model=cm)
    assert plan.stats_dict["windows_to_fringe"] >= 1
    assert bool(plan.stats_dict["core_nnz"]) == has_core
    _product_close(rows, cols, vals, shape, plan)


@pytest.mark.parametrize("alpha", [None, 0.03])
def test_arxiv_products_match_float64(alpha, arxiv):
    rows, cols, vals, shape = arxiv
    cm = H100 if alpha is None else _low_alpha(alpha)
    plan = spmm.prepare(rows, cols, vals, shape, SpmmConfig(impl="torch"),
                        cost_model=cm)
    assert plan.stats_dict["core_nnz"] == 0
    _product_close(rows, cols, vals, shape, plan)
