"""``core.arrays.sorted_unique`` against ``np.unique``, and the port's graph
generators, which dedupe with it, against ``repro.data.graphs``.

The seeded inputs are made with numpy; every comparison is exact.
"""
import numpy as np
import pytest

from repro_torch.core.arrays import sorted_unique
from repro_torch.data import graphs

_RNG = np.random.RandomState(27)
_CASES = {
    "int64 with duplicates": _RNG.randint(0, 1000, 20000).astype(np.int64),
    "int32 negative": _RNG.randint(-50, 50, 3000).astype(np.int32),
    "int64 keys of a graph": (_RNG.randint(0, 4096, 50000).astype(np.int64)
                              * 4096 + _RNG.randint(0, 4096, 50000)),
    "2-D": _RNG.randint(0, 30, (40, 25)),
    "sorted, no duplicates": np.arange(100, dtype=np.int64),
    "one": np.array([7]),
    "empty": np.zeros(0, np.int64),
    "bool": _RNG.rand(500) < 0.5,
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_sorted_unique_equals_np_unique(name):
    a = _CASES[name]
    got, want = sorted_unique(a), np.unique(a)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(graphs.PAPER_DATASETS))
def test_generate_equals_reference(name):
    pytest.importorskip("jax")
    from repro.data import graphs as jax_graphs

    spec = graphs.PAPER_DATASETS[name]
    got = graphs.generate(spec)
    want = jax_graphs.generate(jax_graphs.PAPER_DATASETS[name])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (graphs.dataset_stats(got[0], got[1], (spec.m, spec.k))
            == jax_graphs.dataset_stats(want[0], want[1], (spec.m, spec.k)))
