"""The structured lane of repro_torch (N:M and bitmap payloads) against the
JAX package.

Inputs are made with numpy from seeds and handed to both packages.

- Packers and detection: bit-equal to ``repro.core.formats``.
- Plan leaves: exactly equal to ``repro.core.spmm.prepare`` (the port's
  ``impl="torch"`` against the reference's ``impl="xla"``), and the hint
  errors raise the same ``PlanBuildError``.
- Plain versions: ``ops.nm_stream_spmm``/``bitmap_stream_spmm`` with
  ``impl="torch"`` within 1e-5 * max(1, max|ref|) of the reference's
  ``impl="xla"`` (the same gather / expand forms, summed in another
  order), and within 1e-4 * max(1, max|ref|) of its Pallas kernels in
  interpret mode (which expand every tile to dense first).
- The slice end to end: ``from_coo(device="cpu")`` -> ``spmm``/``bspmm``
  within 1e-5 * max(1, max|ref|) of ``repro.sparse`` and of the fp64 dense
  product; no executor aliasing between structured and general plans;
  ``update_values`` demotion; ``sddmm`` on a structured plan; interop.
"""
import dataclasses

import numpy as np
import pytest
import torch

# held against the JAX package: skip where it is not installed (the
# card's machine need not have it; tests/test_torch_gpu.py runs there)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.sparse as jax_sp  # noqa: E402
from repro.core import formats as jax_formats  # noqa: E402
from repro.core import plan_ir as jax_plan_ir  # noqa: E402
from repro.core import spmm as jax_spmm  # noqa: E402
from repro.data import graphs  # noqa: E402
from repro.dynamic import update_values as jax_update_values  # noqa: E402
from repro.exec import api as jax_api  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
import repro_torch.sparse as sp  # noqa: E402
from repro_torch.core import formats, plan_ir, spmm  # noqa: E402
from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig  # noqa: E402
from repro_torch.dynamic import update_values  # noqa: E402
from repro_torch.errors import PlanBuildError  # noqa: E402
from repro_torch.exec import api, cache  # noqa: E402
from repro_torch.interop import plan_from_arrays  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from conftest import make_sparse  # noqa: E402

TOL_XLA = 1e-5
TOL_PALLAS = 1e-4
_TIMINGS = ("t_partition_s", "t_reorder_s", "t_pack_s")
_PORT_FIELDS = {f.name for f in dataclasses.fields(SpmmConfig)}


def _close(got, want, tol=TOL_XLA):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, (err, scale)


def nm_coo(rng, m, k, n_pat, m_pat):
    """Exact N:M COO: n_pat nonzeros in every m_pat-wide group of a row."""
    gk = k // m_pat
    top = np.argsort(rng.rand(m, gk, m_pat), axis=2)[:, :, :n_pat]
    rows = np.repeat(np.arange(m), gk * n_pat)
    base = np.broadcast_to(np.arange(gk)[None, :, None] * m_pat, top.shape)
    cols = (base + top).reshape(-1)
    vals = rng.randn(rows.size).astype(np.float32)
    vals = np.where(np.abs(vals) < 1e-3, np.float32(1.0), vals)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape, np.float64)
    np.add.at(a, (rows, cols), np.asarray(vals, np.float64))
    return a


def _spec(name, max_dim):
    spec = graphs.PAPER_DATASETS[name]
    spec = dataclasses.replace(spec, m=min(spec.m, max_dim),
                               k=min(spec.k, max_dim))
    rows, cols, vals = graphs.generate(spec)
    return rows, cols, vals, (spec.m, spec.k)


def _jax_leaves(plan):
    leaves, _ = plan.tree_flatten()
    return {name: np.asarray(x) for name, x in zip(LEAF_NAMES, leaves)}


def _assert_same_plan(ours, theirs):
    """Leaves, format, stats (timings aside) and signature (impl aside)."""
    got = {n: t.numpy() for n, t in ours.leaves().items()}
    for name, want in _jax_leaves(theirs).items():
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        assert np.array_equal(got[name], want), name
    assert ours.matrix_format == theirs.matrix_format
    assert ours.format_params == tuple(theirs.format_params)
    assert ({k: v for k, v in ours.stats if k not in _TIMINGS}
            == {k: v for k, v in theirs.stats if k not in _TIMINGS})
    sig, ref_sig = ours.signature(), theirs.signature()
    assert sig[:5] + sig[6:] == ref_sig[:5] + ref_sig[6:]


def _both(rows, cols, vals, shape, **cfg):
    ours = spmm.prepare(rows, cols, vals, shape,
                        SpmmConfig(impl="torch", **cfg))
    theirs = jax_spmm.prepare(rows, cols, vals, shape,
                              jax_spmm.SpmmConfig(impl="xla", **cfg))
    return ours, theirs


def _nm_stream(rng, t, bm, bk, n_pat, m_pat):
    """A random (T, bm, bk) stream holding at most n_pat nonzeros per
    m_pat-wide group; tile 1 (when there is one) is all zeros."""
    g = rng.randn(t, bm, bk // m_pat, m_pat).astype(np.float32)
    order = np.argsort(rng.rand(*g.shape), axis=-1)
    keep = order < rng.randint(0, n_pat + 1, g.shape[:3] + (1,))
    flat = np.where(keep & (np.abs(g) > 1e-3), g, 0.0).astype(
        np.float32).reshape(t, bm, bk)
    if t > 1:
        flat[1] = 0.0
    return flat


def _bitmap_stream(rng, t, bm, bk, density):
    flat = ((rng.rand(t, bm, bk) < density)
            * rng.randn(t, bm, bk)).astype(np.float32)
    flat[0, 0, 31] = 1.5        # bit 31 of word 0: the int32 sign bit
    flat[0, 1, bk - 1] = -2.0   # the last column (bit 31 of the last word)
    if t > 1:
        flat[1] = 0.0           # an all-empty tile
    return flat


# ---------------------------------------------------------------------------
# packers and detection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_pat,m_pat", [(2, 4), (1, 8), (2, 8), (4, 16),
                                         (1, 32)])
def test_nm_packers_match_reference(n_pat, m_pat):
    rng = np.random.RandomState(n_pat * 100 + m_pat)
    flat = _nm_stream(rng, 3, 16, 64, n_pat, m_pat)
    vals, codes = formats.pack_nm_tiles(flat, n_pat, m_pat)
    jvals, jcodes = jax_formats.pack_nm_tiles(flat, n_pat, m_pat)
    for a, b in ((vals, jvals), (codes, jcodes)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert not vals[1].any() and not codes[1].any()  # the empty tile
    out = formats.unpack_nm_tiles(vals, codes, n_pat, m_pat)
    assert np.array_equal(out, flat)
    assert np.array_equal(
        out, jax_formats.unpack_nm_tiles(jvals, jcodes, n_pat, m_pat))


def test_nm_packer_errors_match_reference():
    bad = np.zeros((1, 8, 32), np.float32)
    bad[0, 0, :3] = 1.0  # 3 nonzeros in the first 4-wide group
    for args in ((bad, 2, 4), (np.zeros((1, 8, 30), np.float32), 1, 4),
                 (np.zeros((1, 8, 32), np.float32), 5, 16)):
        with pytest.raises(ValueError) as ours:
            formats.pack_nm_tiles(*args)
        with pytest.raises(ValueError) as theirs:
            jax_formats.pack_nm_tiles(*args)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("density,bk", [(0.02, 64), (0.15, 64), (0.5, 64),
                                        (0.15, 72)])
def test_bitmap_packers_match_reference(density, bk):
    rng = np.random.RandomState(int(density * 100) + bk)
    flat = _bitmap_stream(rng, 3, 16, bk, density)
    words, packed, row_cap = formats.pack_bitmap_tiles(flat)
    jwords, jpacked, jrow_cap = jax_formats.pack_bitmap_tiles(flat)
    assert row_cap == jrow_cap and row_cap % 8 == 0
    for a, b in ((words, jwords), (packed, jpacked)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert words[0, 0, 0] < 0  # bit 31 set: negative as int32
    out = formats.unpack_bitmap_tiles(words, packed, bk)
    assert np.array_equal(out, flat)
    assert np.array_equal(
        out, jax_formats.unpack_bitmap_tiles(jwords, jpacked, bk))
    # the plain version's device-side expansion agrees bit for bit
    ours = ref.expand_bitmap_tiles(torch.from_numpy(words),
                                   torch.from_numpy(packed), bk)
    assert np.array_equal(ours.numpy(), flat)
    assert np.array_equal(ours.numpy(), np.asarray(jax_ref.expand_bitmap_tiles(
        jnp.asarray(jwords), jnp.asarray(jpacked), bk)))


def test_bitmap_packer_of_empty_tiles_matches_reference():
    flat = np.zeros((2, 8, 64), np.float32)
    words, packed, row_cap = formats.pack_bitmap_tiles(flat)
    jwords, jpacked, jrow_cap = jax_formats.pack_bitmap_tiles(flat)
    assert row_cap == jrow_cap == 8
    assert np.array_equal(words, jwords) and np.array_equal(packed, jpacked)
    assert not words.any()


def _detect_cases():
    rng = np.random.RandomState(5)
    cases = []
    for (m, k, n_pat, m_pat) in ((64, 128, 2, 32), (32, 128, 1, 16),
                                 (40, 64, 2, 4), (48, 96, 1, 8)):
        rows, cols, _ = nm_coo(rng, m, k, n_pat, m_pat)
        cases.append((rows, cols, (m, k)))
    rows, cols, _ = nm_coo(rng, 64, 128, 1, 32)  # near-N:M: one overfull
    cases.append((np.concatenate([rows, np.zeros(6, np.int64)]),
                  np.concatenate([cols, np.arange(32, 38)]), (64, 128)))
    cases.append((np.concatenate([rows, rows]),  # duplicates count once
                  np.concatenate([cols, cols]), (64, 128)))
    _, r, c, _ = make_sparse(rng, 80, 80, 0.1)
    cases.append((r, c, (80, 80)))
    e = np.zeros(0, np.int64)
    cases.append((e, e, (256, 256)))
    m = 256
    diag_r = np.arange(m, dtype=np.int64)
    diag_c = (diag_r // 64) * 64 + rng.randint(0, 64, m)
    cases.append((diag_r, diag_c, (m, m)))
    off = diag_c.copy()
    off[0] = 200
    cases.append((diag_r, off, (m, m)))
    return cases


@pytest.mark.parametrize("case", range(10))
def test_detection_matches_reference(case):
    rows, cols, shape = _detect_cases()[case]
    assert (formats.detect_nm_pattern(rows, cols, shape)
            == jax_formats.detect_nm_pattern(rows, cols, shape))
    assert (formats.detect_block_diagonal(rows, cols, shape)
            == jax_formats.detect_block_diagonal(rows, cols, shape))


def test_format_constants_match_reference():
    for name in ("NM_CANDIDATE_M", "NM_MAX_KEEP_FRACTION",
                 "NM_MIN_GROUP_FILL", "NM_MAX_N", "BITMAP_WORD_BITS"):
        assert getattr(formats, name) == getattr(jax_formats, name), name
    for name in ("SIG_IMPL", "SIG_FRINGE_TIER", "SIG_MATRIX_FORMAT",
                 "SIG_FORMAT_PARAMS", "MATRIX_FORMATS"):
        assert getattr(plan_ir, name) == getattr(jax_plan_ir, name), name


# ---------------------------------------------------------------------------
# plan leaves and hint errors
# ---------------------------------------------------------------------------
def _structured_case(name):
    """(rows, cols, vals, shape, config overrides, expected format)."""
    if name == "2:4-hint":
        rows, cols, vals = nm_coo(np.random.RandomState(24), 256, 256, 2, 4)
        return rows, cols, vals, (256, 256), dict(
            structure_hint=("nm", 2, 4)), ("nm", (2, 4))
    if name == "dlmc-unstr-bitmap":
        return (*_spec("dlmc-unstr", 1024), dict(structure_hint="bitmap"),
                ("bitmap", (2, 8)))
    if name == "dlmc-nm-2-32-soft-hint":
        return (*_spec("dlmc-nm-2-32", 1024), dict(structure_hint="nm"),
                ("nm", (2, 32)))
    pat = {"dlmc-nm-1-32": (1, 32), "dlmc-nm-2-32": (2, 32)}[name]
    return (*_spec(name, 1024), {}, ("nm", pat))


STRUCTURED_CASES = ["dlmc-nm-1-32", "dlmc-nm-2-32", "2:4-hint",
                    "dlmc-unstr-bitmap", "dlmc-nm-2-32-soft-hint"]


@pytest.mark.parametrize("name", STRUCTURED_CASES)
def test_structured_leaves_match_reference(name):
    rows, cols, vals, shape, cfg, (fmt, params) = _structured_case(name)
    ours, theirs = _both(rows, cols, vals, shape, **cfg)
    assert theirs.matrix_format == fmt
    if fmt == "nm":
        assert tuple(theirs.format_params) == params
    _assert_same_plan(ours, theirs)
    assert dict(ours.stats)["matrix_format"] == fmt
    # the general stream always rides along
    assert ours.flat_values.shape[1:] == (128, 64)
    assert torch.count_nonzero(ours.flat_values) == dict(ours.stats)[
        "core_nnz"]


@pytest.mark.parametrize("hint,reorder_cols,match", [
    (("nm", 1, 32), False, "violates"),
    (("nm", 1, 5), False, "dividing"),
    ("nm", True, "reorder_cols"),
    ("bitmap", True, "reorder_cols"),
    (("nm", 2, 4), True, "reorder_cols"),
])
def test_hint_errors_match_reference(hint, reorder_cols, match):
    rng = np.random.RandomState(11)
    a, rows, cols, vals = make_sparse(rng, 256, 256, density=0.2)
    cfg = dict(structure_hint=hint, reorder_cols=reorder_cols)
    with pytest.raises(PlanBuildError, match=match) as ours:
        spmm.prepare(rows, cols, vals, a.shape,
                     SpmmConfig(impl="torch", **cfg))
    with pytest.raises(Exception) as theirs:
        jax_spmm.prepare(rows, cols, vals, a.shape,
                         jax_spmm.SpmmConfig(impl="xla", **cfg))
    assert type(theirs.value).__name__ == "PlanBuildError"
    assert str(ours.value) == str(theirs.value)


def test_unhinted_reorder_cols_stays_general_as_reference():
    rows, cols, vals = nm_coo(np.random.RandomState(3), 256, 256, 1, 32)
    ours, theirs = _both(rows, cols, vals, (256, 256), reorder_cols=True)
    assert ours.matrix_format == theirs.matrix_format == "general"
    _assert_same_plan(ours, theirs)


# ---------------------------------------------------------------------------
# plain versions against the reference's XLA forms and Pallas kernels
# ---------------------------------------------------------------------------
def _stream_meta(rng, t, nw, nkb):
    sw = rng.randint(0, nw, t).astype(np.int32)
    sw[np.isin(sw, (2, 5))] = 0  # windows 2 and 5 stay empty
    sc = rng.randint(0, nkb, t).astype(np.int32)
    return np.sort(sw), sc


def _visited_rows(sw, nw, bm):
    """Rows of the windows the stream visits: the Pallas kernels never
    initialise the output block of a window with no tiles."""
    return np.repeat(np.isin(np.arange(nw), sw), bm)


@pytest.mark.parametrize("n_pat,m_pat", [(2, 4), (1, 32), (4, 16), (2, 8)])
def test_plain_nm_matches_reference_forms(n_pat, m_pat):
    rng = np.random.RandomState(n_pat + m_pat)
    t, nw, nkb, bm, bk, n = 11, 7, 3, 32, 64, 128
    sw, sc = _stream_meta(rng, t, nw, nkb)
    vals, codes = formats.pack_nm_tiles(
        _nm_stream(rng, t, bm, bk, n_pat, m_pat), n_pat, m_pat)
    b = rng.randn(nkb * bk, n).astype(np.float32)
    kw = dict(num_windows=nw, bm=bm, bk=bk, n_pat=n_pat, m_pat=m_pat)
    got = ops.nm_stream_spmm(*map(torch.from_numpy, (sw, sc, vals, codes, b)),
                             impl="torch", **kw)
    jargs = tuple(map(jnp.asarray, (sw, sc, vals, codes, b)))
    _close(got, jax_ops.nm_stream_spmm(*jargs, impl="xla", bn=128, **kw))
    rows = _visited_rows(sw, nw, bm)
    _close(got[rows], np.asarray(jax_ops.nm_stream_spmm(
        *jargs, impl="pallas_interpret", bn=128, **kw))[rows], TOL_PALLAS)
    assert not got.reshape(nw, bm, n)[[2, 5]].any()
    # the chunk bound changes nothing but the summation grouping
    _close(ref.ref_nm_stream_spmm(
        *map(torch.from_numpy, (sw, sc, vals, codes, b)), nw, n_pat, m_pat,
        bk, tile_chunk=3), got.numpy())


@pytest.mark.parametrize("density,bk", [(0.02, 64), (0.5, 64), (0.15, 96)])
def test_plain_bitmap_matches_reference_forms(density, bk):
    rng = np.random.RandomState(int(density * 100) + bk)
    t, nw, nkb, bm, n = 9, 6, 3, 32, 128
    sw, sc = _stream_meta(rng, t, nw, nkb)
    words, packed, row_cap = formats.pack_bitmap_tiles(
        _bitmap_stream(rng, t, bm, bk, density))
    b = rng.randn(nkb * bk, n).astype(np.float32)
    got = ops.bitmap_stream_spmm(
        *map(torch.from_numpy, (sw, sc, words, packed, b)), num_windows=nw,
        bm=bm, bk=bk, row_cap=row_cap, impl="torch")
    jargs = tuple(map(jnp.asarray, (sw, sc, words, packed, b)))
    kw = dict(num_windows=nw, bm=bm, bk=bk, bn=128, row_cap=row_cap)
    _close(got, jax_ops.bitmap_stream_spmm(*jargs, impl="xla", **kw))
    rows = _visited_rows(sw, nw, bm)
    _close(got[rows], np.asarray(jax_ops.bitmap_stream_spmm(
        *jargs, impl="pallas_interpret", **kw))[rows], TOL_PALLAS)
    assert not got.reshape(nw, bm, n)[[2, 5]].any()


def test_structured_dispatch_checks_impl_and_rank():
    z = torch.zeros((1, 1, 1))
    zi = torch.zeros((1, 1, 1), dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    for fn, kw in ((ops.nm_stream_spmm, dict(n_pat=1, m_pat=4)),
                   (ops.bitmap_stream_spmm, dict(row_cap=8))):
        payload = (z, zi) if fn is ops.nm_stream_spmm else (zi, z)
        with pytest.raises(ValueError, match="impl"):
            fn(one, one, *payload, torch.zeros(64, 4), num_windows=1, bm=1,
               bk=64, impl="cuda", **kw)
        with pytest.raises(ValueError, match="rank-2"):
            fn(one, one, *payload, torch.zeros(1, 64, 4), num_windows=1,
               bm=1, bk=64, impl="torch", **kw)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", STRUCTURED_CASES[:4])
def test_spmm_and_bspmm_match_reference(name):
    rows, cols, vals, shape, cfg, (fmt, _) = _structured_case(name)
    A = sp.from_coo(rows, cols, vals, shape, device="cpu", **cfg)
    JA = jax_sp.from_coo(rows, cols, vals, shape, impl="xla", **cfg)
    assert A.plan.matrix_format == JA.plan.matrix_format == fmt
    rng = np.random.RandomState(len(name))
    b = rng.randn(shape[1], 48).astype(np.float32)
    bb = rng.randn(2, shape[1], 24).astype(np.float32)
    a = _dense(rows, cols, vals, shape)
    got = sp.spmm(A, torch.from_numpy(b))
    _close(got, np.asarray(jax_sp.spmm(JA, jnp.asarray(b))))
    _close(got, a @ b.astype(np.float64))
    got_b = sp.bspmm(A, torch.from_numpy(bb))
    _close(got_b, np.asarray(jax_sp.bspmm(JA, jnp.asarray(bb))))
    _close(got_b, np.einsum("mk,bkn->bmn", a, bb.astype(np.float64)))


def test_structured_and_general_never_alias():
    """A structured and a general plan of one matrix carry distinct
    signatures and build one executor each; re-execution builds none."""
    rows, cols, vals = nm_coo(np.random.RandomState(8), 320, 192, 1, 32)
    cfg = SpmmConfig(impl="torch", bn=128, seed=913)
    plan_s = spmm.prepare(rows, cols, vals, (320, 192), cfg)
    plan_g = spmm.prepare(rows, cols, vals, (320, 192),
                          dataclasses.replace(cfg, structure_hint="general"))
    assert (plan_s.matrix_format, plan_g.matrix_format) == ("nm", "general")
    sig_s, sig_g = plan_s.signature(), plan_g.signature()
    assert sig_s != sig_g
    assert plan_ir.sig_matrix_format(sig_s) == "nm"
    assert plan_ir.general_format_sig(sig_s) == sig_g
    b = torch.from_numpy(
        np.random.RandomState(9).randn(192, 16).astype(np.float32))
    before = cache.fused_trace_count()
    out_s = api.execute(plan_s, b)
    assert cache.fused_trace_count() == before + 1
    out_g = api.execute(plan_g, b)
    assert cache.fused_trace_count() == before + 2
    api.execute(plan_s, b)
    api.execute(plan_g, b)
    assert cache.fused_trace_count() == before + 2
    _close(out_s, out_g.numpy().astype(np.float64))


def test_signature_helpers_match_reference():
    rows, cols, vals = nm_coo(np.random.RandomState(4), 256, 256, 1, 32)
    ours, theirs = _both(rows, cols, vals, (256, 256), bn=128)
    sig, jsig = ours.signature(), theirs.signature()
    assert plan_ir.sig_impl(sig) == "torch"
    assert plan_ir.sig_matrix_format(sig) == "nm"
    g = plan_ir.general_format_sig(sig)
    assert plan_ir.sig_matrix_format(g) == "general"
    assert g[plan_ir.SIG_FORMAT_PARAMS] == (0, 0)
    assert plan_ir.general_format_sig(g) == g  # idempotent
    jg = jax_plan_ir.general_format_sig(jsig)
    assert g[:5] + g[6:] == jg[:5] + jg[6:]
    assert plan_ir.sig_impl(("delta", 1)) is None
    assert plan_ir.general_format_sig(("delta", 1)) == ("delta", 1)


@pytest.mark.parametrize("name", ["dlmc-nm-1-32", "dlmc-unstr-bitmap"])
def test_update_values_demotes_like_reference(name):
    rows, cols, vals, shape, cfg, (fmt, _) = _structured_case(name)
    ours, theirs = _both(rows, cols, vals, shape, **cfg)
    assert ours.matrix_format == fmt
    idx = np.arange(vals.size)
    newv = (vals * 2.0).astype(np.float32)
    ours2 = update_values(ours, idx, newv)
    theirs2 = jax_update_values(theirs, idx, newv)
    assert ours2.matrix_format == "general" and ours2.format_params == (0, 0)
    assert ours2.signature() == plan_ir.general_format_sig(ours.signature())
    _assert_same_plan(ours2, theirs2)
    b = np.random.RandomState(2).randn(shape[1], 16).astype(np.float32)
    _close(api.execute(ours2, torch.from_numpy(b)),
           _dense(rows, cols, newv, shape) @ b.astype(np.float64))
    # the original plan is untouched and still runs its packed payload
    assert ours.matrix_format == fmt
    _close(api.execute(ours, torch.from_numpy(b)),
           _dense(rows, cols, vals, shape) @ b.astype(np.float64))
    # the demotion happens once: later updates keep the general signature
    ours3 = update_values(ours2, idx[:1], newv[:1] + 1.0)
    assert ours3.signature() == ours2.signature()


@pytest.mark.parametrize("name", ["dlmc-nm-2-32", "2:4-hint",
                                  "dlmc-unstr-bitmap"])
def test_sddmm_on_structured_plan_matches_reference(name):
    """SDDMM reads the general leaves whatever the payload."""
    rows, cols, vals, shape, cfg, _ = _structured_case(name)
    A = sp.from_coo(rows, cols, vals, shape, device="cpu", **cfg)
    JA = jax_sp.from_coo(rows, cols, vals, shape, impl="xla", **cfg)
    rng = np.random.RandomState(6)
    x = rng.randn(shape[0], 12).astype(np.float32)
    y = rng.randn(12, shape[1]).astype(np.float32)
    got = sp.sddmm(A, x, y)
    _close(got, np.asarray(jax_sp.sddmm(JA, jnp.asarray(x), jnp.asarray(y))))
    _close(got, (x.astype(np.float64) @ y)[rows, cols])


BENCH_PANEL = ["cora", "wiki-RfA", "ogbn-arxiv", "pattern1", "human_gene1",
               "F1", "mouse_gene", "reddit"]


def test_bench_panel_stays_general_bit_identical():
    """Auto selection keeps every panel entry on the general payload, as in
    the reference: the signature of an explicit "general" plan, and the
    same output bit for bit."""
    rng = np.random.RandomState(3)
    for name in BENCH_PANEL:
        rows, cols, vals, shape = _spec(name, 256)
        b = torch.from_numpy(rng.randn(shape[1], 64).astype(np.float32))
        plan_a = spmm.prepare(rows, cols, vals, shape,
                              SpmmConfig(impl="torch"))
        plan_g = spmm.prepare(rows, cols, vals, shape,
                              SpmmConfig(impl="torch",
                                         structure_hint="general"))
        theirs = jax_spmm.prepare(rows, cols, vals, shape,
                                  jax_spmm.SpmmConfig(impl="xla"))
        assert plan_a.matrix_format == theirs.matrix_format == "general", name
        assert plan_a.signature() == plan_g.signature(), name
        assert torch.equal(api.execute(plan_a, b), api.execute(plan_g, b)), name


# ---------------------------------------------------------------------------
# interop: a JAX structured plan carried across
# ---------------------------------------------------------------------------
def _carried(jplan, **meta_overrides):
    cfg = {k: v for k, v in dataclasses.asdict(jplan.config).items()
           if k in _PORT_FIELDS}
    cfg["impl"] = "torch"
    meta = dict(shape=jplan.shape, config=cfg, stats=jplan.stats,
                fringe_tier=jplan.fringe_tier, fringe_bk=jplan.fringe_bk,
                matrix_format=jplan.matrix_format,
                format_params=jplan.format_params)
    meta.update(meta_overrides)
    return plan_from_arrays(_jax_leaves(jplan), meta)


@pytest.mark.parametrize("name", ["dlmc-nm-2-32", "dlmc-unstr-bitmap"])
def test_interop_carries_structured_plans(name):
    rows, cols, vals, shape, cfg, (fmt, _) = _structured_case(name)
    ours, theirs = _both(rows, cols, vals, shape, **cfg)
    carried = _carried(theirs)
    assert carried.matrix_format == fmt
    assert carried.signature() == ours.signature()
    for leaf, t in carried.leaves().items():
        assert torch.equal(t, getattr(ours, leaf)), leaf
    b = np.random.RandomState(1).randn(shape[1], 32).astype(np.float32)
    _close(api.execute(carried, torch.from_numpy(b)),
           np.asarray(jax_api.execute(theirs, jnp.asarray(b))))


def test_interop_rejects_mismatched_structured_payloads():
    rows, cols, vals, shape, cfg, _ = _structured_case("dlmc-nm-2-32")
    theirs = jax_spmm.prepare(rows, cols, vals, shape,
                              jax_spmm.SpmmConfig(impl="xla", **cfg))
    with pytest.raises(PlanBuildError, match="nm_values"):
        _carried(theirs, format_params=(1, 32))
    with pytest.raises(PlanBuildError, match="bitmap"):
        _carried(theirs, matrix_format="bitmap", format_params=(2, 8))
    with pytest.raises(PlanBuildError, match="matrix_format"):
        _carried(theirs, matrix_format="blocked")
