"""repro_torch kernels on the card: each CUDA kernel against its plain version.

Marked ``gpu``: they need a CUDA device and ``nvcc``, and skip without
them.  Run them on a machine with a card::

    python -m pytest -m gpu tests/test_torch_*.py

This file imports only the port (the machine with the card has no JAX).
Tolerance: max |kernel - plain| <= 1e-4 * max(1, max|plain|); both sides
are fp32 summed in different orders (the kernels' tensor-core path is
3xTF32, about fp32 accuracy; no TF32 switch is set).
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.plan_ir import SpmmConfig
from repro_torch.core.spmm import prepare
from repro_torch.data.graphs import PAPER_DATASETS, generate
from repro_torch.exec import api
from repro_torch.kernels import ref
from repro_torch.kernels.dense_tile_spmm import dense_tile_spmm
from repro_torch.kernels.gather_spmm import gather_spmm, gather_spmm_ksharded
from repro_torch.kernels.sddmm import dense_tile_sddmm, gather_sddmm
from repro_torch.kernels.structured_spmm import bitmap_tile_spmm, nm_tile_spmm

pytestmark = pytest.mark.gpu

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got - want).abs().max().item() if got.numel() else 0.0
    assert err <= TOL * max(1.0, want.abs().max().item() if want.numel()
                            else 0.0), err


def _stream(rng, t, nw, nkb, bm, bk):
    sw = rng.randint(0, nw, t).astype(np.int32)
    sc = rng.randint(0, nkb, t).astype(np.int32)
    fv = rng.randn(t, bm, bk).astype(np.float32)
    return sw, sc, fv


@pytest.mark.parametrize("bm,bk,n,empty_windows", [
    (128, 64, 256, False),   # the main path's tile shape
    (128, 64, 100, True),    # ragged N, windows with no tiles
    (16, 8, 70, True),       # small tiles
    (200, 40, 64, False),    # bm above one row chunk, bk not a multiple of 32
])
def test_dense_tile_spmm_matches_plain(cuda, bm, bk, n, empty_windows):
    rng = np.random.RandomState(bm + bk + n)
    nw, nkb = 9, 5
    sw, sc, fv = _stream(rng, 60, nw, nkb, bm, bk)
    if empty_windows:
        sw[np.isin(sw, (2, 7))] = 0
    b = rng.randn(nkb * bk, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, fv, b)]
    before = dense_tile_spmm.launches
    got = dense_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk)
    assert dense_tile_spmm.launches == before + 1
    want = ref.ref_block_stream_spmm(*args, num_windows=nw)
    _close(got, want)
    if empty_windows:
        assert not got.reshape(nw, bm, n)[[2, 7]].any()


def _sparse_tiles(rng, t, bm, bk, density):
    """(t, bm, bk) fp32 tiles, tile i dense at density[i % len(density)]."""
    fv = rng.randn(t, bm, bk).astype(np.float32)
    dens = np.resize(np.asarray(density, np.float64), t)[:, None, None]
    fv[rng.rand(t, bm, bk) >= dens] = 0.0
    return fv


@pytest.mark.parametrize("density,bm,bk,n", [
    ((0.025,), 128, 64, 256),        # Reddit-scale tiles: the walk
    ((0.02, 0.5), 128, 64, 256),     # both paths in one launch
    ((0.02, 0.5), 200, 72, 300),     # a 64-deep and an 8-deep k-slice
    ((0.5, 0.01), 128, 68, 130),     # a 4-deep slice, zero-padded to 8
    ((0.3,), 16, 8, 70),
])
def test_dense_tile_spmm_density_paths_match_plain(cuda, density, bm, bk,
                                                   n):
    rng = np.random.RandomState(int(bk + n + 1000 * density[0]))
    nw, nkb, t = 7, 6, 300
    sw = rng.randint(0, nw, t).astype(np.int32)
    sw[sw == 3] = 0
    sc = rng.randint(0, nkb, t).astype(np.int32)
    fv = _sparse_tiles(rng, t, bm, bk, density)
    b = rng.randn(nkb * bk, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, fv, b)]
    got = dense_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk)
    _close(got, ref.ref_block_stream_spmm(*args, num_windows=nw))
    assert not got.reshape(nw, bm, n)[3].any()


def test_dense_tile_spmm_split_window_is_bit_identical(cuda):
    """One window of 5,000 tiles (split into chunks and reduced), an empty
    window and a short one; two calls agree bit for bit."""
    from repro_torch.kernels.dense_tile_spmm import (
        window_chunks, window_segments,
    )

    rng = np.random.RandomState(5000)
    bm, bk, n, nkb = 128, 64, 256, 40
    sw = np.concatenate([np.zeros(5000), np.full(10, 2)]).astype(np.int32)
    sc = rng.randint(0, nkb, sw.size).astype(np.int32)
    fv = _sparse_tiles(rng, sw.size, bm, bk, (0.025, 0.025, 0.4))
    b = rng.randn(nkb * bk, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, fv, b)]
    segments = window_segments(args[0], 3)
    chunks = window_chunks(segments[1])
    assert chunks.n_slots > 1 and chunks.reduce.shape[0] == 2
    before = dense_tile_spmm.launches
    got = dense_tile_spmm(*args, num_windows=3, bm=bm, bk=bk,
                          segments=segments, chunks=chunks)
    again = dense_tile_spmm(*args, num_windows=3, bm=bm, bk=bk)
    assert dense_tile_spmm.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, ref.ref_block_stream_spmm(*args, num_windows=3,
                                          tile_chunk=256))
    assert not got.reshape(3, bm, n)[1].any()


@pytest.mark.parametrize("n", [256, 96, 300])
def test_gather_spmm_matches_plain(cuda, n):
    rng = np.random.RandomState(n)
    num_rows, k, nnz = 500, 700, 6000
    rows = np.sort(rng.randint(0, num_rows, nnz)).astype(np.int32)
    rows[rows == 17] = 16  # an empty row
    cols = rng.randint(0, k, nnz).astype(np.int32)
    vals = rng.randn(nnz).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (rows, cols, vals, b)]
    got = gather_spmm(*args, num_rows=num_rows)
    want = ref.ref_gather_spmm(*args, num_rows=num_rows)
    _close(got, want)
    assert not got[17].any()


def test_gather_spmm_rejects_unsorted_rows(cuda):
    rows = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    cols = torch.zeros(2, dtype=torch.int32, device=cuda)
    vals = torch.ones(2, dtype=torch.float32, device=cuda)
    b = torch.ones(1, 8, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="row-sorted"):
        gather_spmm(rows, cols, vals, b, num_rows=2)


@pytest.mark.parametrize("k,bk", [(2048, 512), (1000, 256)])
def test_gather_spmm_ksharded_matches_plain(cuda, k, bk):
    """The row walk over the remapped k-bucketed stream, on B as it is
    (K ragged against bk where k = 1000): the plain version on the same
    stream, one launch; with an Inf in the first B row of a padded k-block
    its padding entries give NaN in row 0 as the plain version does."""
    from repro_torch.core.plan_ir import bucket_fringe_kblocks
    from repro_torch.kernels.gather_spmm import kbucket_row_order

    rng = np.random.RandomState(k)
    num_rows, nnz, n = 300, 5000, 256
    key = np.unique(rng.randint(0, num_rows, nnz).astype(np.int64) * k
                    + rng.randint(0, k, nnz))
    pr = (key // k).astype(np.int32)
    pc = (key % k).astype(np.int32)
    pv = rng.randn(pr.size).astype(np.float32)
    k_pad = ((k + bk - 1) // bk) * bk
    kbc, kbr, kbcol, kbv, _ = bucket_fringe_kblocks(pr, pc, pv, k_pad, bk, 8)
    b = rng.randn(k, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (kbc, kbr, kbcol, kbv, b)]
    before = gather_spmm_ksharded.launches
    got = gather_spmm_ksharded(*args, num_rows=num_rows, bk=bk)
    assert gather_spmm_ksharded.launches == before + 1
    want = ref.ref_gather_spmm_kblocked(*args, num_rows, bk)
    _close(got, want)
    order = kbucket_row_order(*args[:3], num_rows, bk)
    assert torch.equal(gather_spmm_ksharded(*args, num_rows=num_rows, bk=bk,
                                            row_order=order), got)
    pad_kb = np.unique(np.repeat(kbc, 8)[kbv == 0])
    b[pad_kb[0] * bk, 7] = np.inf
    args[-1] = torch.from_numpy(b).to(cuda)
    want = ref.ref_gather_spmm_kblocked(*args, num_rows, bk)
    assert torch.isnan(want[0, 7])
    _close_nan(gather_spmm_ksharded(*args, num_rows=num_rows, bk=bk,
                                    row_order=order), want)


@pytest.mark.parametrize("name,budget", [
    ("ogbn-arxiv", None),   # ksharded by default
    ("cora", None),         # resident
    ("cora", 1),            # the reference says "xla"; the card runs resident
])
def test_execute_cuda_matches_plain(cuda, name, budget):
    spec = PAPER_DATASETS[name]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    cfg = dict(fringe_vmem_budget=budget)
    p_cuda = prepare(rows, cols, vals, shape, SpmmConfig(impl="cuda", **cfg))
    p_cpu = prepare(rows, cols, vals, shape, SpmmConfig(impl="torch", **cfg))
    assert p_cuda.fringe_tier == ("ksharded" if name == "ogbn-arxiv"
                                  else "resident")
    rng = np.random.RandomState(0)
    b = rng.randn(spec.k, 256).astype(np.float32)
    got = api.execute(p_cuda, torch.from_numpy(b).to(cuda))
    want = api.execute(p_cpu, torch.from_numpy(b)).to(cuda)
    _close(got, want)
    bb = rng.randn(3, spec.k, 40).astype(np.float32)
    got_b = api.execute(p_cuda, torch.from_numpy(bb).to(cuda))
    want_b = api.execute(p_cpu, torch.from_numpy(bb)).to(cuda)
    _close(got_b, want_b)


@pytest.mark.parametrize("bm,bk,d", [
    (128, 64, 256),   # the main path's tile shape and head width
    (128, 64, 45),    # D not a multiple of 4: 4-byte loads
    (200, 40, 70),    # bm above 128, bk not a power of two
    (16, 8, 3),
    (128, 64, 602),   # D wider than the stage: two D chunks
    (64, 128, 512),   # bk = 128: three D chunks of float4s
])
def test_dense_tile_sddmm_matches_plain(cuda, bm, bk, d):
    """The sampled product: the plain tile stream read at the core slots,
    written at their positions (the rest of out untouched), a duplicate
    slot included; two calls bit-identical; k-blocks cut into segments."""
    from repro_torch.kernels.sddmm import sampled_index

    rng = np.random.RandomState(bm + bk + d)
    nw, nkb, t = 7, 5, 50
    sw = rng.randint(0, nw, t).astype(np.int32)
    sc = rng.randint(0, nkb, t).astype(np.int32)
    xp = rng.randn(nw * bm, d).astype(np.float32)
    ypt = rng.randn(nkb * bk, d).astype(np.float32)
    slots = rng.choice(t * bm * bk, 3000, replace=False)
    lin = np.concatenate([slots, slots[:1], np.full(500, -1)])
    lin = lin[rng.permutation(lin.size)].astype(np.int64)
    args = [torch.from_numpy(a).to(cuda) for a in (sw, sc, lin, xp, ypt)]
    want = ref.ref_tile_sddmm_at_slots(
        *args, torch.full((lin.size,), 7.25, device=cuda), bm, bk)
    before = dense_tile_sddmm.launches
    got = dense_tile_sddmm(*args, torch.full((lin.size,), 7.25,
                                             device=cuda), bm=bm, bk=bk)
    assert dense_tile_sddmm.launches == before + 1
    _close(got, want)
    index = sampled_index(*args[:3], bm=bm, bk=bk, seg_nnz=100)
    assert index.seg_kb.numel() > nkb
    again = dense_tile_sddmm(*args, torch.full((lin.size,), 7.25,
                                               device=cuda), bm=bm, bk=bk,
                             index=index)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


def test_dense_tile_sddmm_empty_and_nonfinite(cuda):
    """No core slot: out untouched and no launch.  An Inf in X or a NaN in
    Y^T reaches exactly its own row's or column's cells."""
    bm, bk, d, nw, nkb = 128, 64, 256, 3, 4
    rng = np.random.RandomState(4)
    sw = np.arange(6, dtype=np.int32) % nw
    sc = np.arange(6, dtype=np.int32) % nkb
    xp = rng.randn(nw * bm, d).astype(np.float32)
    ypt = rng.randn(nkb * bk, d).astype(np.float32)
    tens = [torch.from_numpy(a).to(cuda) for a in (sw, sc)]
    none = torch.full((9,), -1, dtype=torch.int64, device=cuda)
    out = torch.full((9,), 7.25, device=cuda)
    before = dense_tile_sddmm.launches
    dense_tile_sddmm(*tens, none, torch.from_numpy(xp).to(cuda),
                     torch.from_numpy(ypt).to(cuda), out, bm=bm, bk=bk)
    assert dense_tile_sddmm.launches == before and bool((out == 7.25).all())
    xp[5, 3] = np.inf
    ypt[bk + 2, 9] = np.nan
    lin = torch.from_numpy(rng.choice(6 * bm * bk, 4000, replace=False)
                           .astype(np.int64)).to(cuda)
    args = tens + [lin] + [torch.from_numpy(a).to(cuda) for a in (xp, ypt)]
    got = dense_tile_sddmm(*args, bm=bm, bk=bk)
    want = ref.ref_tile_sddmm_at_slots(*args, torch.zeros(4000, device=cuda),
                                       bm, bk)
    assert torch.isnan(want).any() or torch.isinf(want).any()
    _close_nan(got, want)


def _b5_walk(rng, m, k, lengths):
    """A shuffled (unsorted) COO with the given row lengths, its entries'
    output positions a permutation of a longer buffer, and its row walk."""
    rows = np.repeat(np.arange(m), lengths)
    cols = rng.randint(0, k, rows.size)
    perm = rng.permutation(rows.size)
    rows, cols = rows[perm], cols[perm]
    pos = rng.permutation(rows.size + 7)[:rows.size]
    return rows, cols, pos


@pytest.mark.parametrize("d,offset", [(256, 0), (602, 0), (33, 0), (64, 1),
                                      (1, 0), (3, 0), (130, 0)])
def test_gather_sddmm_matches_plain(cuda, d, offset):
    """The row walk against its plain version on a shuffled COO with rows
    of 0, 1 and 5,000 nonzeros: 16- and 8-byte loads where D is a multiple
    of 4 and the panels are aligned, 4-byte loads otherwise (odd D, or a
    panel one float off); positions outside the walk are left as they
    are, and two calls are bit-identical."""
    from repro_torch.core.plan_ir import fringe_row_order

    rng = np.random.RandomState(d + offset)
    m, k = 400, 300
    lengths = rng.randint(0, 30, m)
    lengths[:3] = (0, 1, 5000)
    rows, cols, pos = _b5_walk(rng, m, k, lengths)
    x = torch.from_numpy(rng.randn(m * d + offset).astype(np.float32)).to(
        cuda)[offset:].view(m, d)
    yt = torch.from_numpy(rng.randn(k, d).astype(np.float32)).to(cuda)
    r, c, q = (torch.from_numpy(a).to(cuda) for a in (rows, cols, pos))
    walk = fringe_row_order(r, c, q, m)
    before = gather_sddmm.launches
    got = gather_sddmm(*walk, x, yt, torch.full((pos.size + 7,), 5.0,
                                                device=cuda))
    again = gather_sddmm(*walk, x, yt, torch.full((pos.size + 7,), 5.0,
                                                  device=cuda))
    assert gather_sddmm.launches == before + 2
    want = ref.ref_gather_sddmm(r, c, q, x, yt,
                                torch.full((pos.size + 7,), 5.0, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, want)
    untouched = np.setdiff1d(np.arange(pos.size + 7), pos)
    assert bool((got[torch.from_numpy(untouched).to(cuda)] == 5.0).all())


def test_gather_sddmm_nonfinite_matches_plain(cuda):
    """+Inf, -Inf and NaN in X and in Y^T: the dots that read them are NaN
    or +-Inf in the same cells as the plain version's."""
    from repro_torch.core.plan_ir import fringe_row_order

    rng = np.random.RandomState(5)
    m, k, d = 200, 150, 256
    lengths = rng.randint(0, 40, m)
    rows, cols, pos = _b5_walk(rng, m, k, lengths)
    x = rng.randn(m, d).astype(np.float32)
    yt = rng.randn(k, d).astype(np.float32)
    for arr, vals in ((x, (np.inf, -np.inf, np.nan)),
                      (yt, (np.inf, -np.inf, np.nan, np.inf))):
        for v in vals:
            arr[rng.randint(arr.shape[0]), rng.randint(d)] = v
    args = [torch.from_numpy(a).to(cuda) for a in (rows, cols, pos)]
    xs, ys = (torch.from_numpy(a).to(cuda) for a in (x, yt))
    walk = fringe_row_order(*args, m)
    got = gather_sddmm(*walk, xs, ys, torch.zeros(pos.size + 7, device=cuda))
    want = ref.ref_gather_sddmm(*args, xs, ys,
                                torch.zeros(pos.size + 7, device=cuda))
    assert not torch.isfinite(want).all()
    _close_nan(got, want)


def test_gather_sddmm_variants_match_plain(cuda):
    """Every slice width, unroll depth and cache hint the sweep times
    (gather_sddmm_variant_launch) computes the same dots; an unbuilt
    choice, or a D that is not a multiple of 4, is refused."""
    from repro_torch.core.plan_ir import fringe_row_order
    from repro_torch.kernels import _build

    rng = np.random.RandomState(12)
    m, k, d = 300, 2000, 260
    lengths = rng.randint(0, 100, m)
    rows, cols, pos = _b5_walk(rng, m, k, lengths)
    args = [torch.from_numpy(a).to(cuda) for a in (rows, cols, pos)]
    x = torch.from_numpy(rng.randn(m, d).astype(np.float32)).to(cuda)
    yt = torch.from_numpy(rng.randn(k, d).astype(np.float32)).to(cuda)
    walk = fringe_row_order(*args, m)
    want = ref.ref_gather_sddmm(*args, x, yt, torch.zeros(pos.size + 7,
                                                          device=cuda))
    fn = _build.function("sddmm", "gather_sddmm_variant_launch",
                         (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
                         + (ctypes.c_void_p,))
    stream = torch.cuda.current_stream().cuda_stream
    acc = torch.empty(rows.size, device=cuda)

    def run(slice_cols, unroll, hint, d=d):
        out = torch.zeros(pos.size + 7, device=cuda)
        status = fn(*(t.data_ptr() for t in (*walk, x, yt, out, acc)), m, d,
                    slice_cols, unroll, hint, stream)
        return status, out

    for slice_cols in (32, 64, 128, 256):
        for unroll in (4, 8):
            for hint in (0, 1):
                status, out = run(slice_cols, unroll, hint)
                assert status == 0, (slice_cols, unroll, hint)
                _close(out, want)
    assert run(48, 4, 1)[0] != 0
    assert run(32, 4, 1, d=d - 1)[0] != 0


@pytest.mark.parametrize("name,budget", [("ogbn-arxiv", None), ("cora", 1)])
def test_execute_sddmm_and_attention_cuda_match_plain(cuda, name, budget):
    from repro_torch import sparse as sp
    from repro_torch.models import SparseGraphAttention

    spec = PAPER_DATASETS[name]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    a_cuda = sp.from_coo(rows, cols, vals, shape, device=cuda,
                         fringe_vmem_budget=budget)
    a_cpu = sp.from_coo(rows, cols, vals, shape, device="cpu",
                        fringe_vmem_budget=budget)
    rng = np.random.RandomState(1)
    x = rng.randn(spec.m, 64).astype(np.float32)
    y = rng.randn(64, spec.k).astype(np.float32)
    _close(sp.sddmm(a_cuda, x, y), sp.sddmm(a_cpu, x, y).to(cuda))
    w = [torch.from_numpy((rng.randn(64, 32) / 8).astype(np.float32))
         for _ in range(3)]
    feats = torch.from_numpy(x)
    got = SparseGraphAttention(a_cuda, *w)(feats.to(cuda))
    want = SparseGraphAttention(a_cpu, *w)(feats)
    _close(got, want.to(cuda))


def _window_sorted_stream(rng, t, nw, nkb, empty=(2, 7)):
    sw = rng.randint(0, nw, t).astype(np.int32)
    sw[np.isin(sw, empty)] = 0
    return np.sort(sw), rng.randint(0, nkb, t).astype(np.int32)


@pytest.mark.parametrize("n_pat,m_pat,bm,bk,n", [
    (2, 4, 128, 64, 256),    # 2:4 at the main path's tile shape
    (1, 32, 128, 64, 100),   # 1:32, ragged N
    (4, 16, 128, 64, 256),
    (2, 4, 200, 32, 70),     # bm above one row chunk, small bk
    (2, 4, 128, 64, 2048),   # the pruned-weight paths' N: decode + 3xTF32
    (1, 32, 128, 64, 2048),  # the slot walk
    (3, 4, 128, 64, 256),    # a payload too wide for three ring stages
])
def test_nm_tile_spmm_matches_plain(cuda, n_pat, m_pat, bm, bk, n):
    from repro_torch.core.formats import pack_nm_tiles

    rng = np.random.RandomState(n_pat * 100 + m_pat + bm)
    nw, nkb, t = 9, 5, 60
    sw, sc = _window_sorted_stream(rng, t, nw, nkb)
    g = rng.randn(t, bm, bk // m_pat, m_pat).astype(np.float32)
    keep = np.argsort(rng.rand(*g.shape), axis=-1) < rng.randint(
        0, n_pat + 1, g.shape[:3] + (1,))
    flat = np.where(keep, g, 0.0).astype(np.float32).reshape(t, bm, bk)
    vals, codes = pack_nm_tiles(flat, n_pat, m_pat)
    b = rng.randn(nkb * bk, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, vals, codes, b)]
    kw = dict(num_windows=nw, bm=bm, bk=bk, n_pat=n_pat, m_pat=m_pat)
    before = nm_tile_spmm.launches
    got = nm_tile_spmm(*args, **kw)
    assert nm_tile_spmm.launches == before + 1
    _close(got, ref.ref_nm_stream_spmm(*args, nw, n_pat, m_pat, bk))
    assert not got.reshape(nw, bm, n)[[2, 7]].any()


def test_nm_tile_spmm_adds_slots_into_the_decoded_tile(cuda):
    """An empty slot (position 0, value 0.0) after a real value at position
    0 must add, not assign: the cell keeps the value."""
    bm, bk, n, t = 128, 64, 256, 4
    gk = bk // 4
    vals = np.zeros((t, bm, 2 * gk), np.float32)
    vals[:, :, :gk] = 1.5          # slot 0 of every group
    codes = np.zeros((t, bm, gk), np.int32)   # both slots at position 0
    codes[1] = 2 | (3 << 8)        # tile 1: slot 0 at 2, slot 1 (0.0) at 3
    vals[2, :, gk:] = -0.5         # tile 2: both slots at position 0
    sw = np.zeros(t, np.int32)
    sc = np.arange(t, dtype=np.int32)
    b = np.random.RandomState(4).randn(t * bk, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, vals, codes, b)]
    got = nm_tile_spmm(*args, num_windows=1, bm=bm, bk=bk, n_pat=2, m_pat=4)
    dense = np.zeros((t, bm, bk), np.float32)
    dense[:, :, 0::4] = 1.5
    dense[1] = 0.0
    dense[1, :, 2::4] = 1.5
    dense[2, :, 0::4] = 1.0
    want = torch.from_numpy(np.concatenate(list(dense), 1) @ b).to(cuda)
    _close(got, want)
    _close(got, ref.ref_nm_stream_spmm(*args, 1, 2, 4, bk))


@pytest.mark.parametrize("row_cap,bk,n", [(8, 64, 256), (56, 64, 256),
                                          (8, 72, 90)])
def test_bitmap_tile_spmm_matches_plain(cuda, row_cap, bk, n):
    from repro_torch.core.formats import pack_bitmap_tiles

    rng = np.random.RandomState(row_cap + bk)
    nw, nkb, t, bm = 9, 5, 60, 128
    sw, sc = _window_sorted_stream(rng, t, nw, nkb)
    # every row holds column 31 (bit 31 of word 0, the int32 sign bit) and
    # up to row_cap - 1 others; row 0 of tile 0 is full, so the packer's
    # row capacity is row_cap
    other = np.delete(np.arange(bk), 31)
    keep = (np.argsort(rng.rand(t, bm, bk - 1), axis=-1)
            < rng.randint(0, row_cap, (t, bm, 1)))
    flat = np.zeros((t, bm, bk), np.float32)
    flat[:, :, other] = np.where(keep, rng.randn(t, bm, bk - 1), 0.0)
    flat[:, :, 31] = 1.25
    flat[0, 0, other] = 0.0
    flat[0, 0, other[:row_cap - 1]] = 1.0
    words, packed, cap = pack_bitmap_tiles(flat)
    assert cap == row_cap and (words < 0).any()
    b = rng.randn(nkb * bk, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, words, packed, b)]
    before = bitmap_tile_spmm.launches
    got = bitmap_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk, row_cap=cap)
    assert bitmap_tile_spmm.launches == before + 1
    _close(got, ref.ref_bitmap_stream_spmm(*args, nw, bk))
    assert not got.reshape(nw, bm, n)[[2, 7]].any()


@pytest.mark.parametrize("name,hint,fmt", [
    ("dlmc-nm-1-32", None, "nm"),
    ("dlmc-nm-2-32", ("nm", 2, 32), "nm"),
    ("dlmc-unstr", "bitmap", "bitmap"),
])
def test_execute_structured_cuda_matches_plain(cuda, name, hint, fmt):
    spec = PAPER_DATASETS[name]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    p_cuda = prepare(rows, cols, vals, shape,
                     SpmmConfig(impl="cuda", structure_hint=hint))
    p_cpu = prepare(rows, cols, vals, shape,
                    SpmmConfig(impl="torch", structure_hint=hint))
    assert p_cuda.matrix_format == p_cpu.matrix_format == fmt
    rng = np.random.RandomState(0)
    b = rng.randn(spec.k, 128).astype(np.float32)
    kern = nm_tile_spmm if fmt == "nm" else bitmap_tile_spmm
    before = (kern.launches, dense_tile_spmm.launches)
    got = api.execute(p_cuda, torch.from_numpy(b).to(cuda))
    assert (kern.launches, dense_tile_spmm.launches) == (
        before[0] + 1, before[1])
    _close(got, api.execute(p_cpu, torch.from_numpy(b)).to(cuda))
    bb = rng.randn(2, spec.k, 40).astype(np.float32)
    _close(api.execute(p_cuda, torch.from_numpy(bb).to(cuda)),
           api.execute(p_cpu, torch.from_numpy(bb)).to(cuda))


def _close_nan(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal NaN and +-Inf positions (with their signs), finite cells within
    the tolerance: torch.allclose(..., equal_nan=True) with the scale of
    the finite cells."""
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    _close(got[fin], want[fin])


def _with_nonfinite(rng, b):
    """b with +Inf, -Inf and NaN at three seeded cells each."""
    b = b.copy()
    k, n = b.shape
    for value in (np.inf, -np.inf, np.nan):
        b[rng.randint(0, k, 3), rng.randint(0, n, 3)] = value
    return b


def _bitmap_stream(rng, t, bm, bk, density, row_cap=None):
    """Seeded tiles at the given densities, packed as bitmaps; with
    ``row_cap`` the values are cut to that many per row (rows with more set
    bits read their last value again, as the reference clamps), and bits
    past bk are set in the last word (they select nothing)."""
    from repro_torch.core.formats import pack_bitmap_tiles

    flat = _sparse_tiles(rng, t, bm, bk, density)
    words, values, cap = pack_bitmap_tiles(flat)
    if row_cap is not None:
        values = np.ascontiguousarray(values[:, :, :row_cap])
        cap = row_cap
    if bk % 32:
        junk = rng.randint(0, 2 ** 31, words.shape[:2]).astype(np.int64)
        junk &= ~((1 << (bk % 32)) - 1)
        words[:, :, -1] |= junk.astype(np.int32)
    return words, values, cap


@pytest.mark.parametrize("density,bk,n,row_cap", [
    ((0.02, 0.5), 64, 256, None),    # walk and decode + 3xTF32 in one call
    ((0.02, 0.5), 64, 2048, None),   # the pruned-weight paths' N
    ((0.01,), 64, 200, None),        # walk only, N not a multiple of 128
    ((0.6,), 64, 90, 24),            # rows past row_cap (clamped ranks)
    ((0.03, 0.4), 72, 130, None),    # two k-slices, bits past bk
    ((0.5,), 40, 64, 16),            # one narrow slice, bits past bk
])
def test_bitmap_tile_spmm_paths_match_plain(cuda, density, bk, n, row_cap):
    rng = np.random.RandomState(bk + n + int(100 * density[0]))
    nw, nkb, t, bm = 7, 6, 120, 128
    sw, sc = _window_sorted_stream(rng, t, nw, nkb, empty=(3,))
    words, values, cap = _bitmap_stream(rng, t, bm, bk, density, row_cap)
    if row_cap is not None:
        counts = np.unpackbits(words.view(np.uint8), axis=-1).sum(-1)
        assert counts.max() > cap   # the clamp is exercised
    b = rng.randn(nkb * bk, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda)
            for x in (sw, sc, words, values, b)]
    kw = dict(num_windows=nw, bm=bm, bk=bk, row_cap=cap)
    before = bitmap_tile_spmm.launches
    got = bitmap_tile_spmm(*args, **kw)
    again = bitmap_tile_spmm(*args, **kw)
    assert bitmap_tile_spmm.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, ref.ref_bitmap_stream_spmm(*args, nw, bk))
    assert not got.reshape(nw, bm, n)[3].any()


def test_bitmap_tile_spmm_row_cap_too_wide_raises(cuda):
    """A payload whose one ring stage does not fit in shared memory is
    refused at launch, never run."""
    from repro_torch.errors import DispatchError

    t, bm, bk, cap = 2, 128, 64, 4096
    zeros = dict(device=cuda)
    with pytest.raises(DispatchError):
        bitmap_tile_spmm(
            torch.zeros(t, dtype=torch.int32, **zeros),
            torch.zeros(t, dtype=torch.int32, **zeros),
            torch.zeros((t, bm, 2), dtype=torch.int32, **zeros),
            torch.zeros((t, bm, cap), **zeros), torch.zeros((bk, 8), **zeros),
            num_windows=1, bm=bm, bk=bk, row_cap=cap)


@pytest.mark.parametrize("n", [1, 3, 130, 256, 600])
def test_gather_spmm_rows_match_plain(cuda, n):
    """A row of 5,000 nonzeros, empty rows, rows of one nonzero, and every
    ragged edge of N; two calls agree bit for bit."""
    rng = np.random.RandomState(n)
    k = 3000
    lengths = rng.randint(0, 40, 400)
    lengths[::7] = 0
    lengths[1::7] = 1
    lengths[5] = 5000
    rows = np.repeat(np.arange(lengths.size), lengths).astype(np.int32)
    cols = rng.randint(0, k, rows.size).astype(np.int32)
    vals = rng.randn(rows.size).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (rows, cols, vals, b)]
    before = gather_spmm.launches
    got = gather_spmm(*args, num_rows=lengths.size)
    again = gather_spmm(*args, num_rows=lengths.size)
    assert gather_spmm.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, ref.ref_gather_spmm(*args, num_rows=lengths.size))
    assert not got[lengths == 0].any()


def test_gather_spmm_variants_match_plain(cuda):
    """Every slice width and unroll depth of the sweep's entry point
    computes the same product."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_spmm import csr_indptr

    rng = np.random.RandomState(11)
    num_rows, k, nnz, n = 300, 2000, 20000, 256
    rows = np.sort(rng.randint(0, num_rows, nnz)).astype(np.int32)
    cols = rng.randint(0, k, nnz).astype(np.int32)
    vals = rng.randn(nnz).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    r, c, v, bb = (torch.from_numpy(x).to(cuda) for x in (rows, cols, vals, b))
    indptr = csr_indptr(r, num_rows)
    want = ref.ref_gather_spmm(r, c, v, bb, num_rows)
    fn = _build.function("gather_spmm", "gather_spmm_variant_launch",
                         (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
                         + (ctypes.c_void_p,))
    stream = torch.cuda.current_stream().cuda_stream
    for slice_cols, unroll in ((16, 2), (16, 4), (32, 2), (32, 4), (32, 8),
                               (64, 2), (64, 4), (64, 8), (128, 2), (128, 4),
                               (128, 8), (256, 2), (256, 4), (256, 8)):
        out = torch.empty((num_rows, n), device=cuda)
        status = fn(indptr.data_ptr(), c.data_ptr(), v.data_ptr(),
                    bb.data_ptr(), out.data_ptr(), num_rows, n, slice_cols,
                    unroll, stream)
        assert status == 0, (slice_cols, unroll)
        _close(out, want)


@pytest.mark.parametrize("density", [(0.02,), (0.5,), (0.02, 0.5)])
def test_dense_tile_spmm_nonfinite_b_matches_plain(cuda, density):
    """+Inf, -Inf and NaN in B: every tile entry is multiplied, as in the
    plain (dense) product: 0 * Inf = NaN, a nonzero times Inf = +-Inf."""
    rng = np.random.RandomState(int(100 * density[-1]))
    nw, nkb, t, bm, bk, n = 5, 6, 80, 128, 64, 256
    sw = rng.randint(0, nw, t).astype(np.int32)
    sc = rng.randint(0, nkb, t).astype(np.int32)
    fv = _sparse_tiles(rng, t, bm, bk, density)
    b = _with_nonfinite(rng, rng.randn(nkb * bk, n).astype(np.float32))
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, fv, b)]
    got = dense_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk)
    want = ref.ref_block_stream_spmm(*args, num_windows=nw)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    _close_nan(got, want)
    # finite B on the same tiles keeps the fast paths' answer
    args[3] = torch.from_numpy(rng.randn(nkb * bk, n).astype(np.float32)).to(
        cuda)
    _close(dense_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk),
           ref.ref_block_stream_spmm(*args, num_windows=nw))


@pytest.mark.parametrize("n_pat,m_pat", [(2, 4), (1, 32)])
def test_nm_tile_spmm_nonfinite_b_matches_dense_plain(cuda, n_pat, m_pat):
    """Both N:M paths (decode + 3xTF32 at 2:4, the slot walk at 1:32) give
    the TPU kernel's dense-tile answer with Inf and NaN in B."""
    from repro_torch.core.formats import pack_nm_tiles

    rng = np.random.RandomState(m_pat)
    nw, nkb, t, bm, bk, n = 5, 6, 60, 128, 64, 256
    sw, sc = _window_sorted_stream(rng, t, nw, nkb, empty=(2,))
    g = rng.randn(t, bm, bk // m_pat, m_pat).astype(np.float32)
    keep = np.argsort(rng.rand(*g.shape), axis=-1) < n_pat
    vals, codes = pack_nm_tiles(
        np.where(keep, g, 0.0).astype(np.float32).reshape(t, bm, bk),
        n_pat, m_pat)
    b = _with_nonfinite(rng, rng.randn(nkb * bk, n).astype(np.float32))
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, vals, codes, b)]
    got = nm_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk, n_pat=n_pat,
                       m_pat=m_pat)
    want = ref.ref_nm_stream_spmm_dense(*args, nw, n_pat, m_pat, bk)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    _close_nan(got, want)


@pytest.mark.parametrize("density", [(0.02,), (0.5,), (0.02, 0.5)])
def test_bitmap_tile_spmm_nonfinite_b_matches_plain(cuda, density):
    rng = np.random.RandomState(int(1000 * density[0]))
    nw, nkb, t, bm, bk, n = 5, 6, 60, 128, 64, 200
    sw, sc = _window_sorted_stream(rng, t, nw, nkb, empty=(2,))
    words, values, cap = _bitmap_stream(rng, t, bm, bk, density)
    b = _with_nonfinite(rng, rng.randn(nkb * bk, n).astype(np.float32))
    args = [torch.from_numpy(x).to(cuda)
            for x in (sw, sc, words, values, b)]
    got = bitmap_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk, row_cap=cap)
    want = ref.ref_bitmap_stream_spmm(*args, nw, bk)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    _close_nan(got, want)


@pytest.mark.parametrize("where", [0, -1])
def test_nonfinite_check_covers_unaligned_b_and_its_tail(cuda, where):
    """The check of B reads every element: B one float off 16-byte
    alignment, N = 3, a NaN in its first or its last element."""
    rng = np.random.RandomState(3)
    nw, nkb, t, bm, bk, n = 3, 4, 20, 128, 64, 3
    sw = rng.randint(0, nw, t).astype(np.int32)
    sc = np.arange(t, dtype=np.int32) % nkb
    fv = _sparse_tiles(rng, t, bm, bk, (0.05,))
    flat = torch.from_numpy(
        rng.randn(nkb * bk * n + 1).astype(np.float32)).to(cuda)
    b = flat[1:].view(nkb * bk, n)
    assert b.data_ptr() % 16 != 0
    b.view(-1)[where] = float("nan")
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, fv)] + [b]
    got = dense_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk)
    want = ref.ref_block_stream_spmm(*args, num_windows=nw)
    assert torch.isnan(want).any()
    _close_nan(got, want)


BIG = 3.402e38  # above 3.401993e38: cvt.rna.tf32 rounds it to Inf


def _plant_a(tiles, values=(np.inf, -np.inf, np.nan, BIG, -BIG)):
    """Each value at one cell of tile 0, rows 0, 1, ..."""
    for r, v in enumerate(values):
        tiles[0, r, 3 + 7 * r] = v
    return tiles


def _plant_b(rng, b, values=(BIG, -BIG, BIG, -BIG)):
    """Each value at a seeded cell of b, in distinct columns."""
    cols = rng.permutation(b.shape[1])[:len(values)]
    b[rng.randint(0, b.shape[0], len(values)), cols] = values
    return b


def _unique_stream(nw, nkb, empty=()):
    """Window-sorted tiles, each (window, k-block) pair once, as prepare
    emits them: with +-3.402e38 in distinct columns of B, no output cell
    then sums more than one term of that size (three or more overflow or
    not depending on the order of the sum, which the kernel and the plain
    version do not share)."""
    sw, sc = np.divmod(np.arange(nw * nkb), nkb)
    keep = ~np.isin(sw, empty)
    return sw[keep].astype(np.int32), sc[keep].astype(np.int32)


@pytest.mark.parametrize("density", [(0.02,), (0.5,), (0.02, 0.5)])
@pytest.mark.parametrize("where", ["a", "b"])
def test_dense_tile_spmm_unsplittable_matches_plain(cuda, density, where):
    """Inf, NaN and +-3.402e38 in A's values (``where="a"``), or +-3.402e38
    in B: every tile entry is multiplied in fp32, as in the plain version
    (the 3xTF32 split would turn them into NaN).  The flag from the plan's
    own computation gives the same answer as the wrapper's."""
    from repro_torch.core.plan_ir import unsplittable_flag

    rng = np.random.RandomState(int(100 * density[-1]) + len(where))
    nw, nkb, bm, bk, n = 5, 6, 128, 64, 256
    sw, sc = _unique_stream(nw, nkb)
    perm = rng.permutation(sw.size)   # the kernel takes any tile order
    sw, sc = sw[perm], sc[perm]
    fv = _sparse_tiles(rng, sw.size, bm, bk, density)
    b = rng.randn(nkb * bk, n).astype(np.float32)
    if where == "a":
        fv = _plant_a(fv)
    else:
        b = _plant_b(rng, b)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, fv, b)]
    want = ref.ref_block_stream_spmm(*args, num_windows=nw)
    assert not torch.isfinite(want).all()
    _close_nan(dense_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk), want)
    _close_nan(dense_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk,
                               a_flag=unsplittable_flag(args[2])), want)


@pytest.mark.parametrize("n_pat,m_pat", [(2, 4), (1, 32)])
@pytest.mark.parametrize("where", ["a", "b"])
def test_nm_tile_spmm_unsplittable_matches_dense_plain(cuda, n_pat, m_pat,
                                                       where):
    from repro_torch.core.formats import pack_nm_tiles

    rng = np.random.RandomState(m_pat + len(where))
    nw, nkb, bm, bk, n = 5, 6, 128, 64, 256
    sw, sc = _unique_stream(nw, nkb, empty=(2,))
    t = sw.size
    g = rng.randn(t, bm, bk // m_pat, m_pat).astype(np.float32)
    keep = np.argsort(rng.rand(*g.shape), axis=-1) < n_pat
    flat = np.where(keep, g, 0.0).astype(np.float32).reshape(t, bm, bk)
    b = rng.randn(nkb * bk, n).astype(np.float32)
    if where == "a":
        rows = np.flatnonzero(flat[0].any(axis=1))[:5]
        for r, v in zip(rows, (np.inf, -np.inf, np.nan, BIG, -BIG)):
            flat[0, r, np.flatnonzero(flat[0, r])[0]] = v
    else:
        b = _plant_b(rng, b)
    vals, codes = pack_nm_tiles(flat, n_pat, m_pat)
    args = [torch.from_numpy(x).to(cuda) for x in (sw, sc, vals, codes, b)]
    got = nm_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk, n_pat=n_pat,
                       m_pat=m_pat)
    want = ref.ref_nm_stream_spmm_dense(*args, nw, n_pat, m_pat, bk)
    assert not torch.isfinite(want).all()
    _close_nan(got, want)


@pytest.mark.parametrize("density", [(0.02,), (0.5,)])
@pytest.mark.parametrize("where", ["a", "b"])
def test_bitmap_tile_spmm_unsplittable_matches_plain(cuda, density, where):
    from repro_torch.core.formats import pack_bitmap_tiles

    rng = np.random.RandomState(int(1000 * density[0]) + len(where))
    nw, nkb, bm, bk, n = 5, 6, 128, 64, 200
    sw, sc = _unique_stream(nw, nkb, empty=(2,))
    flat = _sparse_tiles(rng, sw.size, bm, bk, density)
    b = rng.randn(nkb * bk, n).astype(np.float32)
    if where == "a":
        flat = _plant_a(flat)
    else:
        b = _plant_b(rng, b)
    words, values, cap = pack_bitmap_tiles(flat)
    args = [torch.from_numpy(x).to(cuda)
            for x in (sw, sc, words, values, b)]
    got = bitmap_tile_spmm(*args, num_windows=nw, bm=bm, bk=bk, row_cap=cap)
    want = ref.ref_bitmap_stream_spmm(*args, nw, bk)
    assert not torch.isfinite(want).all()
    _close_nan(got, want)


def test_execute_cuda_with_inf_in_a_matches_plain(cuda):
    """Through the entry points: a plan whose core holds an Inf routes the
    card's matrix path to every-entry products (the plan's flag, read on
    the device), and a value update that removes it returns to the fast
    path; each against the CPU plan."""
    from repro_torch import sparse as sp
    from repro_torch.core.plan_ir import PATH_CORE

    spec = PAPER_DATASETS["cora"]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    a_cpu = sp.from_coo(rows, cols, vals, shape, device="cpu")
    core = np.flatnonzero(a_cpu.plan.update_maps.path == PATH_CORE)
    assert core.size
    vals = vals.copy()
    vals[core[0]] = np.inf
    a_cpu = sp.from_coo(rows, cols, vals, shape, device="cpu")
    a_cuda = sp.from_coo(rows, cols, vals, shape, device=cuda)
    assert int(a_cuda.plan.a_unsplittable) == 1
    b = np.random.RandomState(0).randn(spec.k, 64).astype(np.float32)
    want = sp.spmm(a_cpu, torch.from_numpy(b))
    assert torch.isinf(want).any()
    _close_nan(sp.spmm(a_cuda, b), want.to(cuda))
    fixed = vals.copy()
    fixed[core[0]] = 1.0
    a2 = a_cuda.with_values(fixed)
    assert int(a2.plan.a_unsplittable) == 0
    _close(sp.spmm(a2, b),
           sp.spmm(a_cpu.with_values(fixed), torch.from_numpy(b)).to(cuda))


def test_cuda_gradients_match_library(cuda):
    """A "cuda" spmm, bspmm and sddmm with grad-requiring operands return
    gradients: spmm's and bspmm's against torch.sparse.mm on the CSR of
    the same COO with autograd, sddmm's against fp64 dense autograd; and
    after with_values, against the new values."""
    from repro_torch import sparse as sp

    spec = PAPER_DATASETS["cora"]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    a = sp.from_coo(rows, cols, vals, shape, device=cuda)
    rng = np.random.RandomState(17)
    idx = torch.from_numpy(np.stack([rows, cols])).to(cuda)

    def csr(v):
        return torch.sparse_coo_tensor(
            idx, torch.as_tensor(v, dtype=torch.float32, device=cuda),
            shape).coalesce().to_sparse_csr()

    for m, v in ((a, vals), (a.with_values(rng.randn(rows.size)
                                           .astype(np.float32)), None)):
        v = m.val if v is None else v
        b = torch.from_numpy(rng.randn(spec.k, 16).astype(np.float32)).to(
            cuda).requires_grad_(True)
        g = torch.from_numpy(rng.randn(spec.m, 16).astype(np.float32)).to(
            cuda)
        (sp.spmm(m, b) * g).sum().backward()
        b_ref = b.detach().clone().requires_grad_(True)
        (torch.sparse.mm(csr(v), b_ref) * g).sum().backward()
        _close(b.grad, b_ref.grad)
    bb = torch.from_numpy(rng.randn(3, spec.k, 8).astype(np.float32)).to(
        cuda).requires_grad_(True)
    gb = torch.from_numpy(rng.randn(3, spec.m, 8).astype(np.float32)).to(
        cuda)
    (sp.bspmm(a, bb) * gb).sum().backward()
    bb_ref = bb.detach().clone().requires_grad_(True)
    lib = csr(vals)
    (torch.stack([torch.sparse.mm(lib, bb_ref[i]) for i in range(3)])
     * gb).sum().backward()
    _close(bb.grad, bb_ref.grad)
    x = torch.from_numpy(rng.randn(spec.m, 8).astype(np.float32)).to(
        cuda).requires_grad_(True)
    y = torch.from_numpy(rng.randn(8, spec.k).astype(np.float32)).to(
        cuda).requires_grad_(True)
    gs = torch.from_numpy(rng.randn(rows.size).astype(np.float32)).to(cuda)
    (sp.sddmm(a, x, y) * gs).sum().backward()
    x64, y64 = (t.detach().double().requires_grad_(True) for t in (x, y))
    r, c = (torch.from_numpy(t).to(cuda) for t in (rows, cols))
    ((x64 @ y64)[r, c] * gs.double()).sum().backward()
    _close(x.grad, x64.grad.float())
    _close(y.grad, y64.grad.float())


def test_cuda_spspmm_bit_equal_to_plain(cuda):
    """``A @ A`` on the card: the pattern of the CPU product, values bit
    for bit (each output slot summed left to right in term order on both
    devices), again on a second run; operands on two devices raise."""
    from repro_torch import sparse as sp
    from repro_torch.errors import DispatchError
    from repro_torch.exec import execute_spspmm

    spec = PAPER_DATASETS["cora"]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    a_cpu = sp.from_coo(rows, cols, vals, shape, device="cpu")
    a_cuda = sp.from_coo(rows, cols, vals, shape, device=cuda)
    p_cpu = execute_spspmm(a_cpu.plan, a_cpu.plan)
    p_cuda = execute_spspmm(a_cuda.plan, a_cuda.plan)
    again = execute_spspmm(a_cuda.plan, a_cuda.plan)
    assert np.array_equal(p_cuda[0], p_cpu[0])
    assert np.array_equal(p_cuda[1], p_cpu[1])
    assert p_cuda[2].device.type == "cuda" and p_cuda[2].numel() > 0
    for got in (p_cuda[2], again[2]):
        assert torch.equal(got.cpu().view(torch.int32),
                           p_cpu[2].view(torch.int32))
    product = a_cuda @ a_cuda
    assert product.device.type == "cuda"
    assert product.plan.config == a_cuda.plan.config
    with pytest.raises(DispatchError, match="different devices"):
        execute_spspmm(a_cuda.plan, a_cpu.plan)


def test_cuda_health_gate_raises_without_launch(cuda):
    """A failed "cuda" build raises KernelLoweringError and is recorded;
    the dispatch inside the backoff raises with no launch; the retry
    launches and is bit-equal to an unarmed call."""
    from repro_torch import sparse as sp
    from repro_torch.core.plan_ir import sig_impl
    from repro_torch.errors import KernelLoweringError
    from repro_torch.exec.health import HEALTH
    from repro_torch.kernels import ops
    from repro_torch.robust.faults import HARNESS, armed

    spec = PAPER_DATASETS["cora"]
    rows, cols, vals = generate(spec)
    a = sp.from_coo(rows, cols, vals, (spec.m, spec.k), device=cuda)
    sig = a.plan.signature()
    b = torch.from_numpy(np.random.RandomState(9).randn(
        7, spec.k, 8).astype(np.float32)).to(cuda)
    HARNESS.reset()
    HEALTH.reset()
    try:
        with armed("executor_build", times=1,
                   match=lambda s: sig_impl(s) == "cuda"):
            with pytest.raises(KernelLoweringError):
                sp.bspmm(a, b)
            assert HEALTH.state(sig) == "retrying"
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with pytest.raises(KernelLoweringError, match="retrying"):
                sp.bspmm(a, b)
            assert not any(ops.launch_counts().values())
            retry = sp.bspmm(a, b)
        assert any(ops.launch_counts().values())
        assert HEALTH.state(sig) == "healthy"
        assert HEALTH.snapshot()["recoveries"] == 1
        unarmed = sp.bspmm(a, b)
        assert torch.equal(retry.view(torch.int32), unarmed.view(torch.int32))
    finally:
        HARNESS.reset()
        HEALTH.reset()


def test_cuda_deadline(cuda):
    """deadline=0.0 raises DeadlineExceeded once the card is synchronised;
    deadline=120.0 returns the bits of the call without one."""
    from repro_torch import sparse as sp
    from repro_torch.errors import DeadlineExceeded

    spec = PAPER_DATASETS["cora"]
    rows, cols, vals = generate(spec)
    a = sp.from_coo(rows, cols, vals, (spec.m, spec.k), device=cuda)
    rng = np.random.RandomState(4)
    b = torch.from_numpy(rng.randn(spec.k, 16).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.randn(spec.m, 8).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.randn(8, spec.k).astype(np.float32)).to(cuda)
    for call in (lambda **kw: sp.spmm(a, b, **kw),
                 lambda **kw: sp.sddmm(a, x, y, **kw),
                 lambda **kw: torch.from_numpy(sp.spspmm(a, a, **kw).val)):
        with pytest.raises(DeadlineExceeded):
            call(deadline=0.0)
        assert torch.equal(call(deadline=120.0).view(torch.int32),
                           call().view(torch.int32))


@pytest.mark.parametrize("tier,budget", [
    ("resident", None),
    ("ksharded", 400 * 256 * 4),   # a k-block stream beside 256 rows
    ("resident", 16),              # the reference says "xla"
])
def test_delta_sidecar_matches_plain(cuda, tier, budget):
    """A dynamic plan's sidecar on the card (B2's walk in the padded
    stream's row order, or B3's over its k-bucketed copy) against the
    plain gather on the same padded stream, one launch of its kernel;
    with +-Inf and NaN in B, and an Inf in B's row 0, which the padding
    entries (row 0, col 0, 0.0) turn into NaN in packed row 0, as the
    plain version does."""
    from repro_torch.core.plan_ir import build_delta_fringe
    from repro_torch.kernels import ops

    rng = np.random.RandomState(11)
    shape = (300, 3000)
    key = rng.choice(shape[0] * shape[1], 150, replace=False)
    cfg = SpmmConfig(impl="cuda", fringe_vmem_budget=budget)
    df = build_delta_fringe(key // shape[1], key % shape[1], rng.randn(150),
                            shape, cfg)
    assert df.tier == tier and df.count < df.capacity
    rows, cols, vals, _gsrc, kbc, kbr, kbcol, kbv = df.leaves
    kernel = "gather_spmm_ksharded" if tier == "ksharded" else "gather_spmm"
    b = rng.randn(shape[1], 256).astype(np.float32)
    for bmat in (b, _with_nonfinite(rng, b.copy())):
        bmat = bmat.copy()
        bmat[0, 9] = np.inf
        bt = torch.from_numpy(bmat).to(cuda)
        ops.reset_launch_counts()
        got = ops.delta_fringe_spmm(
            rows, cols, vals, bt, num_rows=df.capacity, impl="cuda",
            tier=df.tier, bk=df.bk, kb_chunk=kbc, kb_rows=kbr,
            kb_cols=kbcol, kb_vals=kbv, derived={})
        counts = ops.launch_counts()
        assert counts[kernel] == 1 and sum(counts.values()) == 1, counts
        want = ref.ref_gather_spmm(rows, cols, vals, bt, df.capacity)
        assert bool(torch.isnan(want[0, 9]))
        _close_nan(got, want)


@pytest.mark.parametrize("tier,budget", [
    ("resident", None),
    ("ksharded", 400 * 256 * 4),
])
def test_delta_sidecar_cut_padding_is_bit_equal(cuda, tier, budget):
    """The sidecar's row order with its padding cut
    (``gather_spmm.sidecar_row_order``) against the walk over every
    padding entry (``stream_row_order``/``kbucket_row_order``), on the
    card: bit-equal on a finite B, with signed zeros and underflowing
    products, and the same NaN cells with an Inf in B's row 0."""
    from repro_torch.core.plan_ir import build_delta_fringe
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_spmm import (
        gather_spmm, gather_spmm_ksharded, kbucket_row_order,
        stream_row_order,
    )

    rng = np.random.RandomState(12)
    shape = (300, 3000)
    key = np.unique(np.concatenate([
        [0, 700, 1500, 2900],
        rng.choice(shape[0] * shape[1], 150, replace=False)]))
    cfg = SpmmConfig(impl="cuda", fringe_vmem_budget=budget)
    df = build_delta_fringe(key // shape[1], key % shape[1],
                            rng.randn(key.size), shape, cfg)
    assert df.tier == tier and df.count < df.capacity
    rows, cols, vals, _gsrc, kbc, kbr, kbcol, kbv = df.leaves
    cap = df.capacity
    b = rng.randn(shape[1], 256).astype(np.float32)
    b[rng.rand(*b.shape) < 0.1] = -0.0
    b[rng.rand(*b.shape) < 0.1] = 1e-30
    for bmat in (b, b.copy()):
        if bmat is not b:
            bmat[0, 9] = np.inf
        bt = torch.from_numpy(bmat).to(cuda)
        got = ops.delta_fringe_spmm(
            rows, cols, vals, bt, num_rows=cap, impl="cuda", tier=df.tier,
            bk=df.bk, kb_chunk=kbc, kb_rows=kbr, kb_cols=kbcol, kb_vals=kbv,
            derived={})
        if tier == "ksharded":
            full = gather_spmm_ksharded(
                kbc, kbr, kbcol, kbv, bt, num_rows=cap, bk=df.bk,
                row_order=kbucket_row_order(kbc, kbr, kbcol, cap, df.bk))
        else:
            full = gather_spmm(rows, cols, vals, bt, num_rows=cap,
                               row_order=stream_row_order(rows, cols, cap))
        nan = torch.isnan(full)
        assert torch.equal(torch.isnan(got), nan)
        assert bool(nan[0, 9]) == (bmat is not b)
        assert torch.equal(got[~nan].view(torch.int32),
                           full[~nan].view(torch.int32))


def test_dynamic_plan_cuda_matches_cpu(cuda):
    """DynamicPlan on the card against the same on the CPU through a
    mutation stream, the fold included; B's gradient too."""
    from repro_torch.core.spmm import prepare as prep
    from repro_torch.data.graphs import mutate
    from repro_torch.dynamic import DynamicPlan

    spec = PAPER_DATASETS["cora"]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    gpu = DynamicPlan(prep(rows, cols, vals, shape, SpmmConfig(impl="cuda")),
                      auto_compact=False)
    cpu = DynamicPlan(prep(rows, cols, vals, shape, SpmmConfig(impl="torch"),
                           device="cpu"), auto_compact=False)
    rng = np.random.RandomState(5)
    b = rng.randn(spec.k, 64).astype(np.float32)
    for d in mutate(rows, cols, vals, shape, steps=3, insert_frac=0.02,
                    delete_frac=0.02, update_frac=0.05, seed=1):
        gpu.update(d)
        cpu.update(d)
        _close(gpu.execute(torch.from_numpy(b).to(cuda)).cpu(),
               cpu.execute(torch.from_numpy(b)))
    bt = torch.from_numpy(b).to(cuda).requires_grad_(True)
    g = torch.from_numpy(rng.randn(spec.m, 64).astype(np.float32))
    (gpu.execute(bt) * g.to(cuda)).sum().backward()
    bc = torch.from_numpy(b).requires_grad_(True)
    (cpu.execute(bc) * g).sum().backward()
    _close(bt.grad.cpu(), bc.grad)
    gpu.compact()
    cpu.compact()
    _close(gpu.execute(torch.from_numpy(b).to(cuda)).cpu(),
           cpu.execute(torch.from_numpy(b)))


# --- sharded plans on one card repeated -------------------------------------


def _sharded_pair(cuda, rows, cols, vals, shape, shard_axis, n=4, **cfg):
    """The same COO sharded n ways on the card repeated ("cuda") and on
    the CPU repeated ("torch")."""
    from repro_torch.core.spmm import prepare_sharded
    from repro_torch.distributed import make_spmm_mesh

    gpu = prepare_sharded(rows, cols, vals, shape,
                          make_spmm_mesh(devices=[cuda] * n),
                          SpmmConfig(impl="cuda", **cfg),
                          shard_axis=shard_axis)
    cpu = prepare_sharded(rows, cols, vals, shape,
                          make_spmm_mesh(devices=["cpu"] * n),
                          SpmmConfig(impl="torch", **cfg),
                          shard_axis=shard_axis)
    return gpu, cpu


def _close_nonfinite(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("shard_axis,budget", [
    ("rows", None), ("rows", 40_000), ("rhs", None)])
def test_sharded_plan_on_a_repeated_card_matches_plain(cuda, shard_axis,
                                                       budget):
    """A 4-way mesh of one card: ``execute_sharded`` launches B1 and the
    fringe kernel once per shard per call, and matches the plain version
    on a 4-way CPU mesh, batched too; with an Inf in B's row 0 (which
    every shard's padded fringe reads on the rows axis) its NaN and Inf
    cells are the plain version's (on the rhs axis the card's
    single-device plan's).  The budget puts the fringe on the k-sharded
    tier (B3)."""
    from repro_torch.kernels import ops

    rng = np.random.RandomState(3)
    a = (rng.rand(1200, 300) < 0.02) * rng.randn(1200, 300)
    a[rng.choice(1200, 6, replace=False)] = rng.randn(6, 300)
    rows, cols = np.nonzero(a)
    vals = a[rows, cols].astype(np.float32)
    gpu, cpu = _sharded_pair(cuda, rows, cols, vals, a.shape, shard_axis,
                             fringe_vmem_budget=budget)
    assert gpu.sig[12] and gpu.sig[13]   # a core and a fringe
    tier = gpu.sig[14]
    assert tier == ("ksharded" if budget else "resident")
    fringe = "gather_spmm_ksharded" if tier == "ksharded" else "gather_spmm"
    b = rng.randn(300, 64).astype(np.float32)
    ops.reset_launch_counts()
    got = api.execute_sharded(gpu, torch.from_numpy(b).to(cuda))
    counts = ops.launch_counts()
    assert counts["dense_tile_spmm"] == 4 and counts[fringe] == 4, counts
    want = api.execute_sharded(cpu, torch.from_numpy(b))
    _close(got.cpu(), want)
    assert torch.equal(got, api.execute_sharded(
        gpu, torch.from_numpy(b).to(cuda)))
    bb = rng.randn(2, 300, 32).astype(np.float32)
    _close(api.execute_sharded(gpu, torch.from_numpy(bb).to(cuda)).cpu(),
           api.execute_sharded(cpu, torch.from_numpy(bb)))
    b[0, 5] = np.inf
    b[0, 9] = -np.inf
    b[0, 11] = np.nan
    got = api.execute_sharded(gpu, torch.from_numpy(b).to(cuda))
    if shard_axis == "rows":
        # the padding of every shard's fringe reads B's row 0
        want = api.execute_sharded(cpu, torch.from_numpy(b))
    else:
        # no padding here; the plain "torch" path densifies the tiles above
        # 25 % occupancy, as the reference's "xla" does, and its NaN cells
        # are not the tile kernels' (ROADMAP C5): hold the split of B's
        # columns against the card's single-device plan
        single = prepare(rows, cols, vals, a.shape, SpmmConfig(impl="cuda"))
        want = api.execute(single, torch.from_numpy(b).to(cuda)).cpu()
    _close_nonfinite(got, want)


def test_sharded_padded_fringe_cut_is_bit_equal(cuda):
    """On the card, B2 over a shard's padded fringe in the cut row order
    (``ops._padded_row_order``) gives the bits of the walk over every
    padding entry, an Inf in B's row 0 included."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_spmm import stream_row_order

    rng = np.random.RandomState(8)
    a = (rng.rand(900, 500) < 0.02) * rng.randn(900, 500)
    rows, cols = np.nonzero(a)
    gpu, _ = _sharded_pair(cuda, rows, cols, a[rows, cols], a.shape, "rows")
    nr = gpu.sig[11]
    b = torch.from_numpy(rng.randn(gpu.sig[1][1], 48).astype(np.float32))
    b = b.to(cuda)
    cut_any = False
    for sh in gpu.shards:
        fr, fc, fv = sh.leaves[3:6]
        own = sh.derived["stack_padding"]["fringe"]
        full = stream_row_order(fr, fc, nr)
        cut = ops._padded_row_order(full, own)
        cut_any |= cut.perm.numel() < full.perm.numel()
        for inf in (False, True):
            bb = b.clone()
            if inf:
                bb[0, 3] = float("inf")
            x = gather_spmm(fr, fc, fv, bb, num_rows=nr, row_order=cut)
            y = gather_spmm(fr, fc, fv, bb, num_rows=nr, row_order=full)
            torch.cuda.synchronize()
            assert torch.equal(torch.isnan(x), torch.isnan(y))
            fin = ~torch.isnan(y)
            assert torch.equal(x[fin].view(torch.int32),
                               y[fin].view(torch.int32))
    assert cut_any


def test_sharded_sddmm_and_dynamic_on_a_repeated_card(cuda):
    """The sharded SDDMM (B5 over the global COO) and a rows-sharded
    DynamicPlan with a routed sidecar (B2 on each shard's sidecar) on a
    4-way mesh of one card, against the same on the CPU."""
    from repro_torch.dynamic import DynamicPlan, GraphDelta
    from repro_torch.kernels import ops

    spec = PAPER_DATASETS["cora"]
    rows, cols, vals = generate(spec)
    shape = (spec.m, spec.k)
    gpu, cpu = _sharded_pair(cuda, rows, cols, vals, shape, "rows")
    rng = np.random.RandomState(2)
    x = rng.randn(spec.m, 32).astype(np.float32)
    y = rng.randn(32, spec.k).astype(np.float32)
    ops.reset_launch_counts()
    got = api.execute_sddmm(gpu, torch.from_numpy(x).to(cuda),
                            torch.from_numpy(y).to(cuda))
    assert ops.launch_counts()["gather_sddmm"] >= 1
    _close(got.cpu(), api.execute_sddmm(cpu, torch.from_numpy(x),
                                        torch.from_numpy(y)))
    dg = DynamicPlan(gpu, auto_compact=False)
    dc = DynamicPlan(cpu, auto_compact=False)
    zr, zc = np.nonzero(np.ones(shape, bool))
    pick = rng.choice(zr.size, 200, replace=False)
    delta = GraphDelta.inserts(zr[pick], zc[pick], rng.randn(200))
    dg.update(delta)
    dc.update(delta)
    b = rng.randn(spec.k, 64).astype(np.float32)
    ops.reset_launch_counts()
    out = dg.execute(torch.from_numpy(b).to(cuda))
    counts = ops.launch_counts()
    assert counts["dense_tile_spmm"] == 4 and counts["gather_spmm"] == 8
    _close(out.cpu(), dc.execute(torch.from_numpy(b)))
