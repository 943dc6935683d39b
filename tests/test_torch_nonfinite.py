"""What the matrix path computes where B holds an Inf or a NaN, pinned on
the CPU against the JAX package, and the port's new host helpers against
numpy.

The TPU kernels (``repro.kernels.dense_tile_spmm``, ``nm_tile_spmm`` and
``bitmap_tile_spmm``) multiply every entry of a dense tile, so 0 * Inf and
0 * NaN give NaN and a stored nonzero times Inf gives +-Inf.  The card's
kernels follow them (tests/test_torch_gpu.py holds them against the plain
versions here).  Inputs are made with numpy from seeds and handed to both
packages; the Pallas kernels run in interpret mode, as the JAX package's
own tests run them.  Comparisons use ``equal_nan``: NaN and +-Inf in the
same cells (Inf with its sign), finite cells within the stated tolerance.

- The flat tile stream and the bitmap stream: the port's plain versions
  equal both the reference's oracles and its Pallas kernels.
- Inf, NaN and values the kernels' 3xTF32 split cannot carry (|x| >=
  3.401993e38) in A's stored values, with finite B: the general, N:M and
  bitmap plain versions equal the reference's oracles and its Pallas
  kernels cell for cell; the plan's ``a_unsplittable`` flag, which routes
  the card's kernels to every-entry products, is set by ``prepare`` and
  follows ``update_values``.
- The N:M stream: the reference has two forms that differ here.  Its
  Pallas kernel expands each tile (every cell multiplied); its ``"xla"``
  oracle, ``ref_nm_stream_spmm``, multiplies only the packed slots.  The
  port keeps both: ``ref_nm_stream_spmm`` (the ``"torch"`` impl) equals
  the oracle, ``ref_nm_stream_spmm_dense`` (the kernel's plain version)
  the Pallas kernel.  The oracle pads its last scan chunk with zero-valued
  tiles that read B row 0, which turns an Inf there into NaN in window 0
  (inert only for finite B); its stream below is a whole number of chunks,
  so that the comparison is of the two forms and not of that padding.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.dense_tile_spmm import (  # noqa: E402
    dense_tile_spmm as jax_dense_tile_spmm,
)
from repro.kernels.structured_spmm import (  # noqa: E402
    _nm_expand as jax_nm_expand,
    bitmap_tile_spmm as jax_bitmap_tile_spmm,
    nm_tile_spmm as jax_nm_tile_spmm,
)
from repro_torch.core import formats  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.dense_tile_spmm import (  # noqa: E402
    dense_tile_spmm, nonfinite_flags,
)
from repro_torch.kernels.gather_spmm import (  # noqa: E402
    HOT_ROW_SHARES, LONG_ROW, csr_indptr, fringe_profile,
)
from repro_torch.kernels.structured_spmm import (  # noqa: E402
    bitmap_tile_spmm, nm_tile_spmm,
)

# fp32 on both sides, summed in other orders (the Pallas kernels in
# interpret mode run XLA's CPU dot)
TOL = 1e-5
NW, NKB, BM, N = 4, 3, 32, 128


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal_nan(got, want, rows=None):
    got, want = _np(got), _np(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    scale = max(1.0, float(np.abs(want[fin]).max()) if fin.any() else 0.0)
    err = float(np.abs(got[fin].astype(np.float64) - want[fin]).max()
                if fin.any() else 0.0)
    assert err <= TOL * scale, (err, scale)


def _meta(rng, t):
    """Window-sorted stream metadata; window 2 has no tiles."""
    sw = rng.randint(0, NW, t).astype(np.int32)
    sw[sw == 2] = 0
    return np.sort(sw), rng.randint(0, NKB, t).astype(np.int32)


def _b(rng, bk, values=(np.inf, -np.inf, np.nan)):
    """B with each of ``values`` at two seeded cells."""
    b = rng.randn(NKB * bk, N).astype(np.float32)
    for v in values:
        b[rng.randint(0, NKB * bk, 2), rng.randint(0, N, 2)] = v
    return b


def _tiles(rng, t, bk, density):
    fv = rng.randn(t, BM, bk).astype(np.float32)
    fv[rng.rand(t, BM, bk) >= density] = 0.0
    fv[0, 0, :4] = 1.0   # tf32-exact values: the split's lo part is 0
    return fv


def _visited(sw):
    return np.repeat(np.isin(np.arange(NW), sw), BM)


def _nonfinite_cells(out):
    out = _np(out)
    return int(np.isnan(out).sum()), int(np.isinf(out).sum())


VALUES = [(np.inf,), (-np.inf,), (np.nan,), (np.inf, -np.inf, np.nan)]


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("density", [0.03, 0.5])
def test_block_stream_nonfinite_matches_reference(values, density):
    rng = np.random.RandomState(int(100 * density) + len(values))
    bk, t = 64, 16
    sw, sc = _meta(rng, t)
    fv = _tiles(rng, t, bk, density)
    b = _b(rng, bk, values)
    got = ref.ref_block_stream_spmm(*map(torch.from_numpy, (sw, sc, fv, b)),
                                    NW)
    nan, inf = _nonfinite_cells(got)
    assert nan > 0 and (inf > 0 or np.isnan(values).all())
    jargs = tuple(map(jnp.asarray, (sw, sc, fv, b)))
    _equal_nan(got, jax_ref.ref_block_stream_spmm(*jargs, NW))
    _equal_nan(got, jax_dense_tile_spmm(*jargs, num_windows=NW, bm=BM,
                                        bk=bk, bn=N, interpret=True),
               _visited(sw))
    # the wrapper on a CPU tensor runs this plain version
    _equal_nan(dense_tile_spmm(*map(torch.from_numpy, (sw, sc, fv, b)),
                               num_windows=NW, bm=BM, bk=bk), got)


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("density,bk", [(0.03, 64), (0.5, 64), (0.2, 96)])
def test_bitmap_stream_nonfinite_matches_reference(values, density, bk):
    rng = np.random.RandomState(int(100 * density) + bk + len(values))
    t = 12
    sw, sc = _meta(rng, t)
    words, packed, cap = formats.pack_bitmap_tiles(_tiles(rng, t, bk,
                                                          density))
    b = _b(rng, bk, values)
    targs = tuple(map(torch.from_numpy, (sw, sc, words, packed, b)))
    got = ref.ref_bitmap_stream_spmm(*targs, NW, bk)
    assert _nonfinite_cells(got)[0] > 0
    jargs = tuple(map(jnp.asarray, (sw, sc, words, packed, b)))
    _equal_nan(got, jax_ref.ref_bitmap_stream_spmm(*jargs, NW, bk))
    _equal_nan(got, jax_bitmap_tile_spmm(*jargs, num_windows=NW, bm=BM,
                                         bk=bk, bn=N, row_cap=cap,
                                         interpret=True), _visited(sw))
    _equal_nan(bitmap_tile_spmm(*targs, num_windows=NW, bm=BM, bk=bk,
                                row_cap=cap), got)


def _nm_payload(rng, t, bk, n_pat, m_pat):
    g = rng.randn(t, BM, bk // m_pat, m_pat).astype(np.float32)
    keep = np.argsort(rng.rand(*g.shape), axis=-1) < rng.randint(
        0, n_pat + 1, g.shape[:3] + (1,))
    g[0, 0, 0] = 0.0
    g[0, 0, 0, :n_pat] = 1.0   # tf32-exact values in a full group
    keep[0, 0, 0] = np.arange(m_pat) < n_pat
    flat = np.where(keep, g, 0.0).astype(np.float32).reshape(t, BM, bk)
    return formats.pack_nm_tiles(flat, n_pat, m_pat)


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("n_pat,m_pat", [(2, 4), (1, 32), (4, 16)])
def test_nm_stream_dense_nonfinite_matches_tpu_kernel(values, n_pat, m_pat):
    """The kernel's plain version (every cell multiplied) equals the TPU
    kernel, in interpret mode, with Inf and NaN in B."""
    rng = np.random.RandomState(n_pat * 10 + m_pat + len(values))
    bk, t = 64, 16
    sw, sc = _meta(rng, t)
    vals, codes = _nm_payload(rng, t, bk, n_pat, m_pat)
    b = _b(rng, bk, values)
    targs = tuple(map(torch.from_numpy, (sw, sc, vals, codes, b)))
    kw = dict(num_windows=NW, bm=BM, bk=bk, n_pat=n_pat, m_pat=m_pat)
    got = ref.ref_nm_stream_spmm_dense(*targs, NW, n_pat, m_pat, bk)
    assert _nonfinite_cells(got)[0] > 0
    _equal_nan(got, jax_nm_tile_spmm(*map(jnp.asarray,
                                          (sw, sc, vals, codes, b)),
                                     bn=N, interpret=True, **kw),
               _visited(sw))
    _equal_nan(nm_tile_spmm(*targs, **kw), got)


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("n_pat,m_pat", [(2, 4), (1, 32)])
def test_nm_stream_gather_nonfinite_matches_reference_oracle(values, n_pat,
                                                             m_pat):
    """The ``"torch"`` impl's gather form equals the reference's ``"xla"``
    oracle with Inf and NaN in B, and differs from the dense form exactly
    where a cell no slot selects meets a non-finite B value."""
    rng = np.random.RandomState(n_pat * 7 + m_pat + len(values))
    bk, t = 64, 16   # two scan chunks of the oracle's default 8 tiles
    sw, sc = _meta(rng, t)
    vals, codes = _nm_payload(rng, t, bk, n_pat, m_pat)
    b = _b(rng, bk, values)
    targs = tuple(map(torch.from_numpy, (sw, sc, vals, codes, b)))
    got = ref.ref_nm_stream_spmm(*targs, NW, n_pat, m_pat, bk)
    _equal_nan(got, jax_ref.ref_nm_stream_spmm(
        *map(jnp.asarray, (sw, sc, vals, codes, b)), NW, n_pat, m_pat, bk))
    dense = _np(ref.ref_nm_stream_spmm_dense(*targs, NW, n_pat, m_pat, bk))
    gather = _np(got)
    assert np.isnan(dense).sum() > np.isnan(gather).sum()
    both = np.isfinite(dense) & np.isfinite(gather)
    np.testing.assert_allclose(gather[both], dense[both], rtol=0,
                               atol=TOL * max(1.0, np.abs(dense[both]).max()))
    # with finite B the two forms agree everywhere
    b_fin = np.nan_to_num(b, nan=0.5, posinf=2.0, neginf=-2.0)
    targs = targs[:4] + (torch.from_numpy(b_fin),)
    _equal_nan(ref.ref_nm_stream_spmm(*targs, NW, n_pat, m_pat, bk),
               ref.ref_nm_stream_spmm_dense(*targs, NW, n_pat, m_pat, bk))


# values in A that the 3xTF32 split cannot carry: Inf, NaN, and finite
# magnitudes from 3.401993e38 up (cvt.rna rounds them to Inf)
BIG = np.float32(3.402e38)
A_VALUES = [(np.inf,), (-np.inf,), (np.nan,), (BIG,), (-BIG,),
            (np.inf, -np.inf, np.nan, BIG, -BIG)]


def _plant(tiles, values, cols):
    """Each of ``values`` at one cell of tile 0, in rows 0, 1, ... (one per
    output row, so no row sums two of them in an order-dependent way)."""
    for r, (v, c) in enumerate(zip(values, cols)):
        tiles[0, r, c] = v
    return tiles


def _b_finite(rng, bk):
    return rng.randn(NKB * bk, N).astype(np.float32)


@pytest.mark.parametrize("values", A_VALUES)
@pytest.mark.parametrize("density", [0.03, 0.5])
def test_block_stream_unsplittable_a_matches_reference(values, density):
    rng = np.random.RandomState(int(100 * density) + 7 * len(values))
    bk, t = 64, 16
    sw, sc = _meta(rng, t)
    fv = _plant(_tiles(rng, t, bk, density), values, [3, 9, 17, 40, 63])
    b = _b_finite(rng, bk)
    targs = tuple(map(torch.from_numpy, (sw, sc, fv, b)))
    got = ref.ref_block_stream_spmm(*targs, NW)
    assert not np.isfinite(_np(got)).all() or np.isfinite(values).all()
    jargs = tuple(map(jnp.asarray, (sw, sc, fv, b)))
    _equal_nan(got, jax_ref.ref_block_stream_spmm(*jargs, NW))
    _equal_nan(got, jax_dense_tile_spmm(*jargs, num_windows=NW, bm=BM,
                                        bk=bk, bn=N, interpret=True),
               _visited(sw))
    _equal_nan(dense_tile_spmm(*targs, num_windows=NW, bm=BM, bk=bk), got)


@pytest.mark.parametrize("values", A_VALUES)
@pytest.mark.parametrize("density,bk", [(0.03, 64), (0.5, 96)])
def test_bitmap_stream_unsplittable_a_matches_reference(values, density,
                                                         bk):
    rng = np.random.RandomState(int(100 * density) + bk + 7 * len(values))
    t = 12
    sw, sc = _meta(rng, t)
    words, packed, cap = formats.pack_bitmap_tiles(_plant(
        _tiles(rng, t, bk, density), values, [1, 30, 31, 32, bk - 1]))
    b = _b_finite(rng, bk)
    targs = tuple(map(torch.from_numpy, (sw, sc, words, packed, b)))
    got = ref.ref_bitmap_stream_spmm(*targs, NW, bk)
    jargs = tuple(map(jnp.asarray, (sw, sc, words, packed, b)))
    _equal_nan(got, jax_ref.ref_bitmap_stream_spmm(*jargs, NW, bk))
    _equal_nan(got, jax_bitmap_tile_spmm(*jargs, num_windows=NW, bm=BM,
                                         bk=bk, bn=N, row_cap=cap,
                                         interpret=True), _visited(sw))
    _equal_nan(bitmap_tile_spmm(*targs, num_windows=NW, bm=BM, bk=bk,
                                row_cap=cap), got)


@pytest.mark.parametrize("values", A_VALUES)
@pytest.mark.parametrize("n_pat,m_pat", [(2, 4), (1, 32)])
def test_nm_stream_unsplittable_a_matches_reference(values, n_pat, m_pat):
    """Both N:M forms (the kernel's dense plain version and the ``"torch"``
    impl's gather form) against the Pallas kernel and the reference's
    oracle: with finite B the two forms agree, non-finite A included."""
    rng = np.random.RandomState(n_pat * 10 + m_pat + 7 * len(values))
    bk, t = 64, 16
    sw, sc = _meta(rng, t)
    g = rng.randn(t, BM, bk // m_pat, m_pat).astype(np.float32)
    keep = np.argsort(rng.rand(*g.shape), axis=-1) < n_pat
    keep[0, :, 0] = np.arange(m_pat) < n_pat   # position 0 of group 0 kept
    g[0, :len(values), 0, 0] = values
    vals, codes = formats.pack_nm_tiles(
        np.where(keep, g, 0.0).astype(np.float32).reshape(t, BM, bk),
        n_pat, m_pat)
    b = _b_finite(rng, bk)
    targs = tuple(map(torch.from_numpy, (sw, sc, vals, codes, b)))
    jargs = tuple(map(jnp.asarray, (sw, sc, vals, codes, b)))
    kw = dict(num_windows=NW, bm=BM, bk=bk, n_pat=n_pat, m_pat=m_pat)
    dense = ref.ref_nm_stream_spmm_dense(*targs, NW, n_pat, m_pat, bk)
    _equal_nan(dense, jax_nm_tile_spmm(*jargs, bn=N, interpret=True, **kw),
               _visited(sw))
    _equal_nan(nm_tile_spmm(*targs, **kw), dense)
    gather = ref.ref_nm_stream_spmm(*targs, NW, n_pat, m_pat, bk)
    _equal_nan(gather, jax_ref.ref_nm_stream_spmm(*jargs, NW, n_pat, m_pat,
                                                  bk))
    _equal_nan(gather, dense)


def _core_plan(value):
    """A CPU plan of a matrix with dense rows (so it has a core), its first
    core nonzero set to ``value``; returns (plan, that nonzero's index)."""
    import repro_torch.sparse as sp
    from conftest import make_sparse
    from repro_torch.core.plan_ir import PATH_CORE

    rng = np.random.RandomState(5)
    _, rows, cols, vals = make_sparse(rng, 150, 120, 0.04, n_dense_rows=30)
    plan = sp.from_coo(rows, cols, vals, (150, 120), device="cpu").plan
    core = np.flatnonzero(plan.update_maps.path == PATH_CORE)
    assert core.size
    vals = vals.copy()
    vals[core[0]] = value
    return sp.from_coo(rows, cols, vals, (150, 120), device="cpu").plan, \
        core[0]


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan, BIG, -BIG])
def test_plan_flag_follows_the_values(value):
    """``prepare`` sets the plan's flag where a core value cannot be split;
    a value update that removes the value clears it, one that writes it
    back sets it; a finite plan's flag is 0."""
    from repro_torch.dynamic import update_values

    plan, i = _core_plan(value)
    flag = plan.a_unsplittable
    assert flag.dtype == torch.int32 and flag.shape == (1,)
    assert int(flag) == 1
    assert "a_unsplittable" not in plan.derived
    cleared = update_values(plan, [i], [1.5])
    assert int(cleared.a_unsplittable) == 0 and int(plan.a_unsplittable) == 1
    assert int(update_values(cleared, [i], [value]).a_unsplittable) == 1
    finite, _ = _core_plan(np.float32(3.4019e38))   # just below the limit
    assert int(finite.a_unsplittable) == 0


def test_plan_flag_is_the_kernels_threshold():
    """The flag reads bits: 0x7f7ff000 (3.401993e38) and up, either sign,
    and every NaN payload; the largest float below it is splittable."""
    from repro_torch.core.plan_ir import (
        TF32_SPLIT_LIMIT_BITS, unsplittable_flag,
    )

    limit = np.array([TF32_SPLIT_LIMIT_BITS], np.int32).view(np.float32)[0]
    assert np.isclose(limit, 3.401993e38, rtol=1e-7)
    below = np.nextafter(limit, np.float32(0))
    nan2 = np.array([0x7FC00001, -1], np.int32).view(np.float32)
    for v, want in ((below, 0), (-below, 0), (limit, 1), (-limit, 1),
                    (nan2[0], 1), (nan2[1], 1), (np.float32(0), 0)):
        arr = np.zeros(70, np.float32)
        arr[-1] = v
        assert int(unsplittable_flag(torch.from_numpy(arr))) == want, v
    assert int(unsplittable_flag(torch.zeros(0))) == 0


@pytest.mark.parametrize("n_pat,m_pat", [(1, 4), (2, 4), (3, 8), (1, 32)])
def test_expand_nm_tiles_matches_reference_expand(n_pat, m_pat):
    """Bit-equal to the TPU kernel's _nm_expand, tile by tile, including an
    empty slot (position 0, value 0.0) after a real value at position 0
    and a position of m or more (selects no cell)."""
    rng = np.random.RandomState(n_pat + m_pat)
    bk, t = 64, 3
    vals, codes = _nm_payload(rng, t, bk, n_pat, m_pat)
    gk = bk // m_pat
    if n_pat > 1:
        codes[1, :, 0] = 0          # every slot at position 0
        vals[1, :, gk] = 0.0        # slot 1 empty after slot 0's value
    codes[2, 3, 1] = m_pat | (m_pat << 8)   # positions past the group
    got = ref.expand_nm_tiles(torch.from_numpy(vals), torch.from_numpy(codes),
                              n_pat, m_pat, bk).numpy()
    for i in range(t):
        want = np.asarray(jax_nm_expand(jnp.asarray(vals[i]),
                                        jnp.asarray(codes[i]), n_pat, m_pat,
                                        bk))
        np.testing.assert_array_equal(got[i], want)


def test_nonfinite_flags_match_the_check_kernel():
    """The wrappers allocate as many flags as the check writes (one per
    block of tile_core's nonfinite_kernel, then A's flag), as int32 on B's
    device, and the check's threshold is the plan flag's."""
    import re
    from pathlib import Path

    from repro_torch.core.plan_ir import TF32_SPLIT_LIMIT_BITS
    from repro_torch.kernels import _build
    from repro_torch.kernels.dense_tile_spmm import NONFINITE_FLAGS

    header = (Path(_build.CSRC) / "tile_core.cuh").read_text()
    blocks = int(re.search(r"kFlagBlocks\s*=\s*(\d+);", header).group(1))
    assert re.search(r"kFlagInts\s*=\s*kFlagBlocks\s*\+\s*1;", header)
    assert blocks + 1 == NONFINITE_FLAGS
    limit = int(re.search(r"kSplitLimitBits\s*=\s*(0x[0-9a-f]+)u;",
                          header).group(1), 16)
    assert limit == TF32_SPLIT_LIMIT_BITS
    flags = nonfinite_flags(torch.zeros(3, 2))
    assert flags.shape == (NONFINITE_FLAGS,) and flags.dtype == torch.int32
    assert flags.device.type == "cpu"


def _fringe(rng, num_rows, k, lengths):
    rows = np.repeat(np.arange(num_rows), lengths).astype(np.int32)
    cols = (k * rng.power(0.3, rows.size)).astype(np.int32) % k
    return rows, cols


@pytest.mark.parametrize("seed,num_rows,k", [(0, 50, 3000), (1, 400, 20000),
                                             (2, 7, 100)])
def test_fringe_profile_matches_numpy(seed, num_rows, k):
    """Row-length quantiles, the long-row share and the hot-column shares,
    against numpy."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, 60, num_rows)
    lengths[::5] = 0
    lengths[1] = LONG_ROW + 37
    rows, cols = _fringe(rng, num_rows, k, lengths)
    got = fringe_profile(csr_indptr(torch.from_numpy(rows), num_rows),
                         torch.from_numpy(cols), k)
    nnz = rows.size
    assert got["rows"] == num_rows and got["nnz"] == nnz
    assert got["max"] == lengths.max()
    np.testing.assert_allclose([got["p50"], got["p99"]],
                               np.quantile(lengths, [0.5, 0.99]))
    assert got["long_share"] == pytest.approx(
        lengths[lengths > LONG_ROW].sum() / nnz)
    freq = np.sort(np.bincount(cols, minlength=k))[::-1]
    for share in HOT_ROW_SHARES:
        count = min(k, max(1, int(np.ceil(round(share * k, 6)))))
        assert got["hot_share"][f"{share:g}"] == pytest.approx(
            freq[:count].sum() / nnz)


def test_fringe_profile_of_generator_columns_is_skewed():
    """The generator's column law (k * power(0.3)) puts about half of the
    nonzeros in the first 10 % of B's rows."""
    rng = np.random.RandomState(3)
    rows, cols = _fringe(rng, 2000, 50000, np.full(2000, 100))
    got = fringe_profile(csr_indptr(torch.from_numpy(rows), 2000),
                         torch.from_numpy(cols), 50000)
    assert 0.45 < got["hot_share"]["0.1"] < 0.55
    assert got["long_share"] == 0.0 and got["p50"] == 100.0


@pytest.mark.parametrize("bk,density", [(64, 0.5), (72, 0.1), (40, 0.02),
                                        (32, 0.0)])
def test_pack_bitmap_tiles_torch_matches_numpy_packer(bk, density):
    rng = np.random.RandomState(bk)
    flat = rng.randn(5, 16, bk).astype(np.float32)
    flat[rng.rand(*flat.shape) >= density] = 0.0
    flat[0, 0, 31] = -2.0   # bit 31: the int32 sign bit
    words, packed, cap = formats.pack_bitmap_tiles(flat)
    w2, p2, cap2 = formats.pack_bitmap_tiles_torch(torch.from_numpy(flat))
    assert cap2 == cap
    np.testing.assert_array_equal(w2.numpy(), words)
    np.testing.assert_array_equal(p2.numpy(), packed)
