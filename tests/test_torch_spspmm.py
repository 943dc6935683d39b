"""Sparse x sparse (``spspmm``) in the port, on the CPU, against the JAX
package.

Mirrors ``tests/test_operator_family.py``'s SpGEMM tests: the dense
oracle, duplicates accumulating like the dense product, empty and
disjoint inputs, one dispatch with no rebuild.  Each product is also held
against ``repro.exec.execute_spspmm`` on ``impl="xla"`` plans of the same
COO: rows and cols exactly equal, values within 1e-6 * max(1, max |ref|).
They are bit-equal too, and the tests assert it: both sum each output
slot's terms left to right in term order, in fp32, from 0 (the
reference's sorted ``segment_sum`` on the CPU, the port's
``torch.segment_reduce``), and the products are the same fp32 products.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sparse as jsp
from repro.core import spmm as jspmm
from repro.exec import execute_spspmm as ref_execute_spspmm
import repro_torch.sparse as sp
from repro_torch.core import spmm
from repro_torch.errors import DispatchError, PlanBuildError
from repro_torch.exec import dispatch_count, execute_spspmm, fused_trace_count

TOL = 1e-6


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape, np.float64)
    if len(rows):
        np.add.at(a, (rows, cols), np.asarray(vals, np.float64))
    return a


def _coo(rng, m, k, nnz):
    rows = rng.randint(0, m, nnz).astype(np.int64)
    cols = rng.randint(0, k, nnz).astype(np.int64)
    return rows, cols, rng.randn(nnz)


def _pair(a_coo, a_shape, b_coo, b_shape, **cfg):
    """Port plans ("torch", CPU) and reference plans ("xla") of two COOs."""
    port = [spmm.prepare(*coo, shape, spmm.SpmmConfig(impl="torch", **cfg),
                         device="cpu")
            for coo, shape in ((a_coo, a_shape), (b_coo, b_shape))]
    ref = [jspmm.prepare(*coo, shape, jspmm.SpmmConfig(impl="xla", **cfg))
           for coo, shape in ((a_coo, a_shape), (b_coo, b_shape))]
    return port, ref


def _check_against_reference(port, ref):
    cr, cc, cv, cshape = execute_spspmm(*port)
    rr, rc, rv, rshape = ref_execute_spspmm(*ref)
    rv = np.asarray(rv)
    assert cshape == rshape
    assert np.array_equal(cr, rr) and np.array_equal(cc, rc)
    got = cv.numpy()
    assert got.dtype == np.float32 and got.shape == rv.shape
    if got.size:
        err = float(np.abs(got.astype(np.float64) - rv).max())
        assert err <= TOL * max(1.0, float(np.abs(rv).max())), err
    assert np.array_equal(got.view(np.int32), rv.view(np.int32))  # bits
    return cr, cc, got, cshape


@pytest.mark.parametrize("m,k,n,nnz_a,nnz_b", [
    (64, 56, 48, 300, 250),       # the reference test's sizes
    (200, 180, 190, 4000, 3500),  # long runs per output slot
])
def test_spspmm_matches_oracle(rng, m, k, n, nnz_a, nnz_b):
    a, b = _coo(rng, m, k, nnz_a), _coo(rng, k, n, nnz_b)
    port, ref = _pair(a, (m, k), b, (k, n))
    cr, cc, cv, cshape = _check_against_reference(port, ref)
    assert cshape == (m, n)
    want = _dense(*a, (m, k)) @ _dense(*b, (k, n))
    got = np.zeros(cshape)
    got[cr, cc] = cv.astype(np.float64)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # row-major output, unique pattern: ready for from_coo directly
    assert np.all(np.diff(cr * n + cc) > 0)


def test_spspmm_duplicates_accumulate_like_dense(rng):
    """Duplicate COO triplets in BOTH inputs expand independently."""
    a = (np.array([0, 0, 1, 1]), np.array([2, 2, 3, 0]), rng.randn(4))
    b = (np.array([2, 2, 3, 0, 0]), np.array([1, 1, 4, 2, 2]), rng.randn(5))
    port, ref = _pair(a, (2, 4), b, (4, 6))
    cr, cc, cv, cshape = _check_against_reference(port, ref)
    want = _dense(*a, (2, 4)) @ _dense(*b, (4, 6))
    got = np.zeros(cshape)
    got[cr, cc] = cv.astype(np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _prep(rows, cols, vals, shape):
    return spmm.prepare(np.asarray(rows), np.asarray(cols),
                        np.asarray(vals, np.float64), shape,
                        spmm.SpmmConfig(impl="torch"), device="cpu")


def test_spspmm_empty_and_disjoint():
    empty = _prep(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0),
                  (8, 8))
    pa = _prep([0], [1], [2.0], (8, 8))
    for a, b in ((empty, pa), (pa, empty)):
        cr, cc, cv, cshape = execute_spspmm(a, b)
        assert cr.size == 0 and cc.size == 0 and cv.shape == (0,)
        assert cshape == (8, 8) and cv.dtype == torch.float32
    # structurally disjoint: A's columns never meet a B row
    pb = _prep([5], [3], [1.0], (8, 8))
    cr, cc, cv, _ = execute_spspmm(pa, pb)
    assert cr.size == 0 and cv.shape == (0,)
    with pytest.raises(ValueError, match="inner"):
        execute_spspmm(pa, _prep([0], [0], [1.0], (9, 4)))


def test_spspmm_one_dispatch_zero_rebuild(rng):
    m, k, n = 48, 40, 32
    pa = _prep(*_coo(rng, m, k, 200), (m, k))
    pb = _prep(*_coo(rng, k, n, 180), (k, n))
    first = execute_spspmm(pa, pb)  # builds
    t0, d0 = fused_trace_count(), dispatch_count()
    second = execute_spspmm(pa, pb)
    execute_spspmm(pa, pb)
    assert fused_trace_count() - t0 == 0
    assert dispatch_count() - d0 == 2
    assert torch.equal(first[2], second[2])


def test_spspmm_typed_errors(rng):
    pa = _prep(*_coo(rng, 16, 12, 30), (16, 12))
    pb = _prep(*_coo(rng, 12, 10, 30), (12, 10))
    with pytest.raises(PlanBuildError, match="update_maps"):
        execute_spspmm(dataclasses.replace(pa, update_maps=None), pb)
    with pytest.raises(PlanBuildError, match="update_maps"):
        execute_spspmm(pa, dataclasses.replace(pb, update_maps=None))
    elsewhere = dataclasses.replace(pb, step_window=pb.step_window.to("meta"))
    with pytest.raises(DispatchError, match="different devices"):
        execute_spspmm(pa, elsewhere)


def test_facade_spspmm_matches_the_jax_facade(rng):
    """``sp.spspmm`` and ``A @ B`` give a prepared SparseMatrix on A's
    device with A's config, equal to the JAX facade's product."""
    m, k, n = 70, 64, 50
    a, b = _coo(rng, m, k, 400), _coo(rng, k, n, 300)
    A = sp.from_coo(*a, (m, k), device="cpu", bm=32, bk=16)
    B = sp.from_coo(*b, (k, n), device="cpu")
    P = sp.spspmm(A, B)
    assert isinstance(P, sp.SparseMatrix)
    assert P.shape == (m, n) and P.device == A.device
    assert P.plan.config == A.plan.config
    Q = A @ B
    for x, y in zip(P.coo(), Q.coo()):
        assert np.array_equal(x, y)
    ref = jsp.spspmm(jsp.from_coo(*a, (m, k), impl="xla", bm=32, bk=16),
                     jsp.from_coo(*b, (k, n), impl="xla"))
    for x, y in zip(P.coo(), ref.coo()):
        assert np.array_equal(x, np.asarray(y))
    # the product takes the whole operator family
    rhs = rng.randn(n, 6).astype(np.float32)
    out = sp.spmm(P, torch.from_numpy(rhs)).numpy().astype(np.float64)
    want = _dense(*a, (m, k)) @ _dense(*b, (k, n)) @ rhs
    assert np.abs(out - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
