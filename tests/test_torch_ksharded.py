"""The k-sharded fringe tier on the row walk, on the CPU.

On the card ``gather_spmm_ksharded`` runs the row-walk kernel of
``gather_spmm`` over the k-bucketed stream remapped once, from its
structure alone, into a row-major order with global columns
(``kbucket_row_order``).  These tests hold what that walk computes (the
plain gather over the remapped stream, values read through ``perm``)
against the JAX package's oracle ``ref_gather_spmm_kblocked`` and the
port's, on streams whose K is ragged against ``bk`` and whose buckets are
padded with zero-valued entries (row 0, column 0 of their k-block): the
remap keeps them, so an Inf in a B row that a padding entry addresses
turns row 0 into NaN, as in the TPU kernel.  They also check that every
global column is below K, so the card reads B unpadded.  Tolerance: max
|diff| <= 1e-5 * max(1, max |ref|); NaN and +-Inf cells must match.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core.plan_ir import bucket_fringe_kblocks  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.gather_spmm import (  # noqa: E402
    gather_spmm_ksharded, kbucket_row_order,
)

TOL = 1e-5
NUM_ROWS, N = 120, 48


def _stream(seed, k, bk, nnz, chunk):
    """A k-bucketed stream as ``prepare`` builds it, from a row-sorted
    unique fringe COO of ``nnz`` draws."""
    rng = np.random.RandomState(seed)
    key = np.unique(rng.randint(0, NUM_ROWS, nnz).astype(np.int64) * k
                    + rng.randint(0, k, nnz))
    pr = (key // k).astype(np.int32)
    pc = (key % k).astype(np.int32)
    pv = rng.randn(pr.size).astype(np.float32)
    k_pad = -(-k // bk) * bk
    kbc, kbr, kbcol, kbv, _ = bucket_fringe_kblocks(pr, pc, pv, k_pad, bk,
                                                    chunk)
    assert kbr.size > pr.size  # some buckets are padded
    return rng, kbc, kbr, kbcol, kbv


def _walk(order, vals, b):
    """What the card's row walk computes over the remapped stream."""
    rows = torch.repeat_interleave(
        torch.arange(NUM_ROWS, dtype=torch.int32),
        (order.indptr[1:] - order.indptr[:-1]).long())
    return ref.ref_gather_spmm(rows, order.cols, vals[order.perm.long()], b,
                               NUM_ROWS)


def _equal_nan(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    err = float(np.abs(got[fin].astype(np.float64) - want[fin]).max())
    assert err <= TOL * max(1.0, float(np.abs(want[fin]).max())), err


@pytest.mark.parametrize("k,bk,chunk", [(1000, 256, 8), (2048, 512, 8),
                                        (777, 64, 5)])
def test_remapped_stream_matches_kblocked_reference(k, bk, chunk):
    rng, kbc, kbr, kbcol, kbv = _stream(k + bk, k, bk, 3000, chunk)
    t = tuple(map(torch.from_numpy, (kbc, kbr, kbcol, kbv)))
    order = kbucket_row_order(*t[:3], NUM_ROWS, bk)
    # a permutation of the whole stream, padding entries included; rows
    # sorted; each row's entries in k-block order; columns global, below K
    perm = order.perm.long().numpy()
    assert np.array_equal(np.sort(perm), np.arange(kbr.size))
    assert np.all(np.diff(kbr[perm]) >= 0)
    gcols = np.repeat(kbc, kbr.size // kbc.size) * bk + kbcol
    assert np.array_equal(order.cols.numpy(), gcols[perm])
    assert int(order.cols.max()) < k
    for r in range(NUM_ROWS):
        seg = perm[order.indptr[r]:order.indptr[r + 1]]
        assert np.all(np.diff(seg) > 0)   # stable: stream order kept
    b = rng.randn(k, N).astype(np.float32)   # K ragged against bk
    got = _walk(order, t[3], torch.from_numpy(b))
    _equal_nan(got, jax_ref.ref_gather_spmm_kblocked(
        *map(jnp.asarray, (kbc, kbr, kbcol, kbv, b)), NUM_ROWS, bk))
    _equal_nan(got, ref.ref_gather_spmm_kblocked(*t, torch.from_numpy(b),
                                                 NUM_ROWS, bk))
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(
        gather_spmm_ksharded(*t, torch.from_numpy(b), num_rows=NUM_ROWS,
                             bk=bk),
        ref.ref_gather_spmm_kblocked(*t, torch.from_numpy(b), NUM_ROWS, bk))


@pytest.mark.parametrize("value", [np.inf, np.nan])
def test_remapped_stream_keeps_padding_entries(value):
    """An Inf or NaN in the first B row of a padded k-block: the padding
    entries (row 0, value 0) add 0 * Inf = NaN to row 0, as the reference
    and the TPU kernel do."""
    k, bk, chunk = 1000, 256, 8
    rng, kbc, kbr, kbcol, kbv = _stream(3, k, bk, 3000, chunk)
    real = (kbv != 0)
    pad_kb = np.unique(np.repeat(kbc, chunk)[~real])
    b = rng.randn(k, N).astype(np.float32)
    b[pad_kb[0] * bk, 5] = value
    t = tuple(map(torch.from_numpy, (kbc, kbr, kbcol, kbv)))
    order = kbucket_row_order(*t[:3], NUM_ROWS, bk)
    got = _walk(order, t[3], torch.from_numpy(b))
    want = jax_ref.ref_gather_spmm_kblocked(
        *map(jnp.asarray, (kbc, kbr, kbcol, kbv, b)), NUM_ROWS, bk)
    assert np.isnan(np.asarray(want)[0, 5])
    _equal_nan(got, want)
