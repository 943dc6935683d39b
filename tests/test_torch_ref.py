"""repro_torch plain kernel versions against the JAX package's oracles.

Every plain version in ``repro_torch.kernels.ref`` (and each kernel
wrapper on CPU tensors, which runs it) is held against its counterpart in
``repro.kernels.ref`` on the same numpy inputs; the dense-tile plain
version is also held against the Pallas kernel in interpret mode.  The
fringe versions are held against the jnp oracles only: the Pallas fringe
kernels do not run on this jax (ROADMAP caveat C1).

Tolerance: max |diff| <= 1e-5 * max(1, max |ref|); both sides are fp32,
summed in different orders.
"""
import numpy as np
import pytest
import torch

# held against the JAX package: skip where it is not installed (the
# card's machine need not have it; tests/test_torch_gpu.py runs there)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import plan_ir as jax_plan_ir  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dense_tile_spmm import dense_tile_spmm as pallas_dense_tile  # noqa: E402
from repro_torch.core.plan_ir import bucket_fringe_kblocks  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.dense_tile_spmm import dense_tile_spmm  # noqa: E402
from repro_torch.kernels.gather_spmm import gather_spmm, gather_spmm_ksharded  # noqa: E402

TOL = 1e-5


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= TOL * scale, (err, scale)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _stream(rng, t, nw, nkb, bm, bk, sort=False):
    """Random tile stream; random pairs repeat, so duplicates are covered."""
    sw = rng.randint(0, nw, t).astype(np.int32)
    sc = rng.randint(0, nkb, t).astype(np.int32)
    if sort:
        order = np.argsort(sw, kind="stable")
        sw, sc = sw[order], sc[order]
    fv = (rng.randn(t, bm, bk) * (rng.rand(t, bm, bk) < 0.4)).astype(
        np.float32)
    return sw, sc, fv


# --- B1: the flat tile stream -------------------------------------------------


@pytest.mark.parametrize("bm,bk,n,empty", [
    (8, 8, 24, False),
    (16, 32, 100, True),    # N not a multiple of 256, windows with no tiles
    (128, 64, 256, False),  # the main path's tile shape
])
def test_block_stream_plain_matches_jax_oracle(bm, bk, n, empty):
    rng = np.random.RandomState(bm + bk + n)
    nw, nkb = 6, 5
    sw, sc, fv = _stream(rng, 40, nw, nkb, bm, bk)
    if empty:
        sw[np.isin(sw, (1, 4))] = 0
    b = rng.randn(nkb * bk, n).astype(np.float32)
    want = jref.ref_block_stream_spmm(*map(jnp.asarray, (sw, sc, fv, b)), nw)
    got = tref.ref_block_stream_spmm(*_t(sw, sc, fv, b), nw)
    _close(got, want)
    for tile_chunk in (1, 7):
        _close(tref.ref_block_stream_spmm(*_t(sw, sc, fv, b), nw,
                                          tile_chunk=tile_chunk), want)
    if empty:
        assert not got.reshape(nw, bm, n)[[1, 4]].any()


def test_densified_plain_matches_jax_oracles():
    rng = np.random.RandomState(3)
    nw, nkb, bm, bk, n = 5, 4, 16, 8, 40
    sw, sc, fv = _stream(rng, 30, nw, nkb, bm, bk)  # duplicate pairs
    b = rng.randn(nkb * bk, n).astype(np.float32)
    want = jref.densified_block_stream_spmm(
        *map(jnp.asarray, (sw, sc, fv, b)), nw)
    _close(tref.densified_block_stream_spmm(*_t(sw, sc, fv, b), nw), want)
    _close(want, jref.ref_block_stream_spmm(
        *map(jnp.asarray, (sw, sc, fv, b)), nw))
    # unique pairs: the gather-densify form
    lin = np.unique(sw.astype(np.int64) * nkb + sc)
    usw, usc = (lin // nkb).astype(np.int32), (lin % nkb).astype(np.int32)
    ufv = fv[: lin.size]
    want_u = jref.densified_block_stream_spmm_unique(
        *map(jnp.asarray, (usw, usc, ufv, b)), nw)
    _close(tref.densified_block_stream_spmm_unique(*_t(usw, usc, ufv, b), nw),
           want_u)


@pytest.mark.parametrize("bm,bk,bn", [(8, 8, 128), (128, 64, 256)])
def test_block_stream_plain_matches_pallas_interpret(bm, bk, bn):
    """The Pallas kernel walks a window-major stream; every window has at
    least one tile (its out block is otherwise never visited)."""
    rng = np.random.RandomState(bm)
    nw, nkb = 4, 6
    sw = np.repeat(np.arange(nw, dtype=np.int32), 3)
    sc = np.concatenate([rng.choice(nkb, 3, replace=False)
                         for _ in range(nw)]).astype(np.int32)
    fv = (rng.randn(sw.size, bm, bk)
          * (rng.rand(sw.size, bm, bk) < 0.3)).astype(np.float32)
    b = rng.randn(nkb * bk, 2 * bn).astype(np.float32)
    want = pallas_dense_tile(*map(jnp.asarray, (sw, sc, fv, b)),
                             num_windows=nw, bm=bm, bk=bk, bn=bn,
                             interpret=True)
    _close(tref.ref_block_stream_spmm(*_t(sw, sc, fv, b), nw), want)


def test_dense_tile_wrapper_on_cpu_runs_plain_and_counts_nothing():
    rng = np.random.RandomState(5)
    sw, sc, fv = _stream(rng, 20, 3, 4, 16, 8, sort=True)
    b = rng.randn(32, 48).astype(np.float32)
    before = dense_tile_spmm.launches
    got = dense_tile_spmm(*_t(sw, sc, fv, b), num_windows=3, bm=16, bk=8)
    assert dense_tile_spmm.launches == before
    _close(got, jref.ref_block_stream_spmm(
        *map(jnp.asarray, (sw, sc, fv, b)), 3))


# --- B2: the row-sorted gather ------------------------------------------------


def _sorted_coo(rng, num_rows, k, nnz):
    rows = np.sort(rng.randint(0, num_rows, nnz)).astype(np.int32)
    cols = rng.randint(0, k, nnz).astype(np.int32)  # duplicate columns too
    vals = rng.randn(nnz).astype(np.float32)
    return rows, cols, vals


@pytest.mark.parametrize("chunk", [None, 1, 3, 16, 1000])
@pytest.mark.parametrize("n", [24, 300])
def test_gather_plain_matches_jax_oracle(chunk, n):
    rng = np.random.RandomState(n + (chunk or 0))
    rows, cols, vals = _sorted_coo(rng, 9, 40, 70)
    b = rng.randn(40, n).astype(np.float32)
    want = jref.ref_gather_spmm(*map(jnp.asarray, (rows, cols, vals, b)), 9)
    _close(tref.ref_gather_spmm(*_t(rows, cols, vals, b), 9, chunk=chunk),
           want)
    want_chunked = jref.ref_gather_spmm(
        *map(jnp.asarray, (rows, cols, vals, b)), 9, chunk=chunk)
    _close(want_chunked, want)


def test_gather_wrapper_on_cpu_runs_plain_and_counts_nothing():
    rng = np.random.RandomState(11)
    rows, cols, vals = _sorted_coo(rng, 12, 30, 90)
    b = rng.randn(30, 64).astype(np.float32)
    before = gather_spmm.launches
    got = gather_spmm(*_t(rows, cols, vals, b), num_rows=12, chunk=7)
    assert gather_spmm.launches == before
    _close(got, jref.ref_gather_spmm(
        *map(jnp.asarray, (rows, cols, vals, b)), 12))


# --- B3: the k-bucketed stream --------------------------------------------------


def _bucketed(rng, num_rows, k, bk, nnz, chunk):
    key = np.unique(rng.randint(0, num_rows, nnz).astype(np.int64) * k
                    + rng.randint(0, k, nnz))
    pr = (key // k).astype(np.int32)
    pc = (key % k).astype(np.int32)
    pv = rng.randn(pr.size).astype(np.float32)
    k_pad = ((k + bk - 1) // bk) * bk
    ours = bucket_fringe_kblocks(pr, pc, pv, k_pad, bk, chunk)
    theirs = jax_plan_ir.bucket_fringe_kblocks(pr, pc, pv, k_pad, bk, chunk)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return (pr, pc, pv), ours[:4]


@pytest.mark.parametrize("k,bk,chunk", [
    (64, 16, 8),    # K a multiple of bk
    (100, 24, 8),   # ragged K
    (300, 64, 5),   # bucket padding in most buckets
])
def test_kblocked_plain_matches_jax_oracles(k, bk, chunk):
    rng = np.random.RandomState(k)
    num_rows, n = 17, 72
    (pr, pc, pv), (kbc, kbr, kbcol, kbv) = _bucketed(
        rng, num_rows, k, bk, 150, chunk)
    assert (kbv == 0).any()  # padding entries are present and must be inert
    b = rng.randn(k, n).astype(np.float32)
    want = jref.ref_gather_spmm_kblocked(
        *map(jnp.asarray, (kbc, kbr, kbcol, kbv, b)), num_rows, bk)
    _close(tref.ref_gather_spmm_kblocked(*_t(kbc, kbr, kbcol, kbv, b),
                                         num_rows, bk), want)
    for step in (1, 7, 1000):  # the stepped gather sums the same entries
        _close(tref.ref_gather_spmm_kblocked(*_t(kbc, kbr, kbcol, kbv, b),
                                             num_rows, bk, step=step), want)
    # the bucketed stream is a relayout of the packed fringe
    _close(want, jref.ref_gather_spmm(
        *map(jnp.asarray, (pr, pc, pv, b)), num_rows))
    before = gather_spmm_ksharded.launches
    got = gather_spmm_ksharded(*_t(kbc, kbr, kbcol, kbv, b),
                               num_rows=num_rows, bk=bk)
    assert gather_spmm_ksharded.launches == before
    _close(got, want)


def test_ref_spmm_dense_matches_jax_oracle():
    rng = np.random.RandomState(2)
    a = rng.randn(20, 30).astype(np.float32)
    b = rng.randn(30, 12).astype(np.float32)
    _close(tref.ref_spmm_dense(*_t(a, b)),
           jref.ref_spmm_dense(jnp.asarray(a), jnp.asarray(b)))
