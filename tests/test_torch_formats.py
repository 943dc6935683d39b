"""The rest of ``core/formats.py`` in the port (COO from dense, CSR,
BlockELL and its constructors): the reference's format tests run on both
packages, and the port's BlockELL leaves equal the reference's for the
same COO."""
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from conftest import make_sparse
from repro.core import formats as jformats
from repro_torch.core import formats as tformats

PACKAGES = [jformats, tformats]
IDS = ["repro", "repro_torch"]


@pytest.mark.parametrize("formats", PACKAGES, ids=IDS)
def test_coo_round_trip(rng, formats):
    a, rows, cols, vals = make_sparse(rng, 50, 40, 0.1)
    coo = formats.coo_from_dense(a)
    assert coo.nnz == len(rows)
    np.testing.assert_allclose(formats.dense_from_coo(coo), a)


@pytest.mark.parametrize("formats", PACKAGES, ids=IDS)
def test_coo_row_sorted(rng, formats):
    a, *_ = make_sparse(rng, 30, 30, 0.2)
    coo = formats.coo_from_dense(a)
    r = np.asarray(coo.rows)
    assert (np.diff(r) >= 0).all()


@pytest.mark.parametrize("formats", PACKAGES, ids=IDS)
@pytest.mark.parametrize("bm,bk", [(8, 8), (16, 32), (128, 64)])
def test_block_ell_round_trip(rng, bm, bk, formats):
    a, rows, cols, vals = make_sparse(rng, 70, 90, 0.08)
    be = formats.block_ell_from_coo(rows, cols, vals, a.shape, bm, bk)
    np.testing.assert_allclose(formats.dense_from_block_ell(be), a, rtol=1e-6)


@pytest.mark.parametrize("formats", PACKAGES, ids=IDS)
def test_block_ell_row_permutation(rng, formats):
    a, rows, cols, vals = make_sparse(rng, 40, 40, 0.1)
    order = np.random.RandomState(1).permutation(40)
    be = formats.block_ell_from_coo(rows, cols, vals, a.shape, 8, 8,
                                    row_order=order)
    np.testing.assert_allclose(formats.dense_from_block_ell(be), a, rtol=1e-6)


@pytest.mark.parametrize("formats", PACKAGES, ids=IDS)
@settings(max_examples=25, deadline=None)
@given(
    m=st.integers(5, 60), k=st.integers(5, 60),
    density=st.floats(0.01, 0.4), seed=st.integers(0, 99),
)
def test_block_ell_nnz_conserved(formats, m, k, density, seed):
    """Property: packing stores every nonzero exactly once."""
    r = np.random.RandomState(seed)
    a = (r.rand(m, k) < density) * r.randn(m, k)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    be = formats.block_ell_from_coo(rows, cols, vals, (m, k), 8, 8)
    assert be.nnz == len(rows)
    dense = formats.dense_from_block_ell(be)
    np.testing.assert_allclose(dense, a, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("formats", PACKAGES, ids=IDS)
def test_active_tile_zero_fraction_trend(rng, formats):
    """Paper Table 1: redundancy grows with tile size."""
    a, rows, cols, _ = make_sparse(rng, 512, 512, 0.01)
    fracs = [
        formats.active_tile_zero_fraction(rows, cols, a.shape, t)
        for t in (4, 16, 32, 64, 128)
    ]
    assert all(b >= a - 1e-9 for a, b in zip(fracs, fracs[1:])), fracs
    assert fracs[-1] > fracs[0]


@pytest.mark.parametrize("formats", PACKAGES, ids=IDS)
def test_empty_matrix(formats):
    be = formats.block_ell_from_coo(
        np.zeros(0, np.int64), np.zeros(0, np.int64),
        np.zeros(0, np.float32), (0, 16), 8, 8,
    )
    assert be.num_windows == 0
    assert be.nnz == 0


@pytest.mark.parametrize("bm,bk,permute,max_blocks", [
    (8, 8, False, None), (16, 32, True, None), (8, 16, True, 12)])
def test_block_ell_leaves_equal_reference(rng, bm, bk, permute, max_blocks):
    a, rows, cols, vals = make_sparse(rng, 70, 90, 0.08, n_dense_rows=2)
    order = np.random.RandomState(2).permutation(70) if permute else None
    want = jformats.block_ell_from_coo(rows, cols, vals, a.shape, bm, bk,
                                       row_order=order,
                                       max_blocks=max_blocks)
    got = tformats.block_ell_from_coo(rows, cols, vals, a.shape, bm, bk,
                                      row_order=order, max_blocks=max_blocks)
    for leaf in ("block_cols", "num_blocks", "values", "row_map"):
        g, w = getattr(got, leaf), np.asarray(getattr(want, leaf))
        assert isinstance(g, torch.Tensor)
        assert g.numpy().dtype == w.dtype, leaf
        assert np.array_equal(g.numpy(), w), leaf
    for meta in ("shape", "bm", "bk", "nnz", "num_windows", "max_blocks",
                 "tile_density"):
        assert getattr(got, meta) == getattr(want, meta), meta
    with pytest.raises(ValueError, match="max_blocks"):
        tformats.block_ell_from_coo(rows, cols, vals, a.shape, bm, bk,
                                    max_blocks=1)


def test_coo_and_csr_equal_reference(rng):
    a, rows, cols, vals = make_sparse(rng, 30, 20, 0.2)
    jc, tc = jformats.coo_from_dense(a, pad_to=16), \
        tformats.coo_from_dense(a, pad_to=16)
    for leaf in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(tc, leaf).numpy(),
                              np.asarray(getattr(jc, leaf))), leaf
    assert (tc.shape, tc.nnz, tc.density) == (jc.shape, jc.nnz, jc.density)
    for jcsr, tcsr in ((jformats.csr_from_dense(a),
                        tformats.csr_from_dense(a)),
                       (jformats.csr_from_coo_np(rows, cols, vals, a.shape),
                        tformats.csr_from_coo_np(rows, cols, vals, a.shape))):
        for leaf in ("indptr", "indices", "data"):
            g, w = getattr(tcsr, leaf), getattr(jcsr, leaf)
            assert g.dtype == w.dtype and np.array_equal(g, w), leaf
        assert tcsr.shape == jcsr.shape and tcsr.nnz == jcsr.nnz
        assert np.array_equal(tcsr.row_lengths(), jcsr.row_lengths())
