"""The frozen block-model generator gives what the program's gives; the
symmetric power-law generator gives what it promises."""
import numpy as np
import pytest
import torch

from nsbench import graphs
from nsbench.generators import chung_lu
from repro_torch.examples.gcn_training import make_graph


@pytest.mark.parametrize("n,nnz,deg,skew,seed", [
    (3000, 120000, 40.0, 1.05, 10), (1000, 30000, 30.0, 1.3, 3),
    (500, 100000, 492.0, 1.05, 10)])
def test_chung_lu_is_symmetric_with_the_count_asked_for(n, nnz, deg, skew,
                                                        seed):
    g = dict(n=n, nonzeros=nnz, avg_degree=deg, skew=skew, seed=seed)
    rows, cols, vals, shape, labels = chung_lu.build(g, torch.device("cpu"))
    assert rows.size == nnz and shape == (n, n)
    assert vals is None and labels is None
    key = rows * n + cols
    assert (np.diff(key) > 0).all()            # sorted, no repeats
    assert not (rows == cols).any()            # no self-loops
    np.testing.assert_array_equal(np.sort(cols * n + rows), key)
    # the same configuration gives the same structure
    again = chung_lu.build(g, torch.device("cpu"))
    np.testing.assert_array_equal(again[0], rows)
    np.testing.assert_array_equal(again[1], cols)
    # the heaviest rows are those of the largest weights
    w = chung_lu.weights(n, deg, skew, seed)
    d = np.bincount(rows, minlength=n)
    assert np.corrcoef(w, d)[0, 1] > 0.5


def test_chung_lu_refuses_an_odd_count():
    with pytest.raises(ValueError):
        chung_lu.build(dict(n=100, nonzeros=101, avg_degree=2.0, skew=1.1,
                            seed=0), torch.device("cpu"))


@pytest.mark.parametrize("kw", [
    dict(n=2000, avg_deg=3.6, n_classes=8, n_features=16, symmetric=True,
         seed=0),
    dict(n=2048, avg_deg=12, n_classes=16, seed=0),
    dict(n=4000, avg_deg=3.6, n_classes=40, n_features=128, symmetric=True,
         seed=5)])
def test_sbm_equals_the_program(kw):
    want = make_graph(**kw)
    got = graphs.make_graph(**kw)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]
    kw.pop("n_features", None)
    rows, cols, vals, labels = graphs.sbm_structure(
        kw["n"], kw["avg_deg"], kw["n_classes"], kw["seed"],
        symmetric=kw.get("symmetric", False))
    for g, w in zip((rows, cols, vals, labels), want[:5][:3] + (want[4],)):
        np.testing.assert_array_equal(g, w)


def test_sorted_unique_equals_numpy():
    a = np.random.RandomState(0).randint(0, 50, 1000)
    np.testing.assert_array_equal(graphs.sorted_unique(a), np.unique(a))
