"""The split of window segments that dense_tile_spmm's CUDA kernel walks,
and the build's header tracking; CPU only (no nvcc, no card).

The chunk table (``window_chunks``/``chunk_table``) cuts each window's
segment of the window-sorted tile stream into chunks; the kernel writes one
partial per chunk of a split window and a second pass sums them in chunk
order.  Here the plain per-chunk products, summed in that order, are held
against the unsplit plain product (fp32 in both, different summation
order: within 1e-5 * max(1, max|unsplit|)).
"""
import numpy as np
import pytest
import torch

from repro_torch.errors import KernelLoweringError
from repro_torch.kernels import _build
from repro_torch.kernels.dense_tile_spmm import (
    CHUNKS_PER_SM, MIN_CHUNK_TILES, chunk_table, dense_tile_spmm,
    window_chunks, window_segments,
)
from repro_torch.kernels.ref import ref_block_stream_spmm


def _segments(lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


# (window lengths, SM count): Reddit-scale's 49 windows of 3,641 tiles on
# 132 SMs, one long window among short and empty ones, windows all below
# the shortest chunk, no tiles at all
CASES = [
    ([3641] * 49, 132),
    ([5000, 0, 10, 0, 700], 132),
    ([3, 63, 64, 65, 0], 4),
    ([0, 0], 132),
    ([129, 1, 0, 4096], 1),
]


@pytest.mark.parametrize("lengths,num_sms", CASES)
def test_every_tile_in_exactly_one_chunk_within_its_window(lengths,
                                                           num_sms):
    seg = _segments(lengths)
    table, reduce, n_slots = chunk_table(seg, num_sms)
    covered = np.zeros(seg[-1], np.int64)
    for w, first, end, _ in table:
        assert seg[w] <= first < end <= seg[w + 1]
        covered[first:end] += 1
    assert np.all(covered == 1)
    # a window of one chunk writes the output (slot -1); a split window's
    # chunks own consecutive slots in chunk order, listed for the reduce
    slots = table[:, 3]
    assert sorted(slots[slots >= 0]) == list(range(n_slots))
    listed = {int(w): (int(s0), int(s1)) for w, s0, s1 in reduce}
    for w, length in enumerate(lengths):
        mine = table[table[:, 0] == w]
        mine = mine[np.argsort(mine[:, 1])]
        if length == 0:
            assert mine.size == 0 and listed[w][0] == listed[w][1]
        elif len(mine) == 1:
            assert mine[0, 3] == -1 and w not in listed
        else:
            assert list(mine[:, 3]) == list(range(*listed[w]))


@pytest.mark.parametrize("lengths,num_sms", CASES)
def test_chunk_lengths_follow_the_sm_count(lengths, num_sms):
    seg = _segments(lengths)
    table, _, _ = chunk_table(seg, num_sms)
    want = max(MIN_CHUNK_TILES,
               -(-int(seg[-1]) // (CHUNKS_PER_SM * num_sms)))
    sizes = table[:, 2] - table[:, 1]
    assert np.all(sizes <= want)
    for w, length in enumerate(lengths):
        assert (table[:, 0] == w).sum() == -(-length // want)
    # chunks are ordered by their position in the window, then by window,
    # so that blocks running together walk the same k-range of B
    pos = np.array([np.sum((table[:i, 0] == w)) for i, w in
                    enumerate(table[:, 0])])
    assert np.all(np.diff(pos) >= 0)


def test_reddit_scale_split_gives_several_waves():
    table, reduce, n_slots = chunk_table(_segments([3641] * 49), 132)
    assert len(table) >= 4 * 132 and n_slots == len(table)
    assert len(reduce) == 49
    sizes = table[:, 2] - table[:, 1]
    assert sizes.max() - sizes.min() <= 1


def test_chunk_table_is_a_deterministic_function_of_the_leaves():
    rng = np.random.RandomState(5)
    sw = torch.from_numpy(rng.randint(0, 7, 3000).astype(np.int32))
    first = window_chunks(window_segments(sw, 7)[1], num_sms=16)
    again = window_chunks(window_segments(sw.clone(), 7)[1], num_sms=16)
    assert first.n_slots == again.n_slots > 0
    assert torch.equal(first.table, again.table)
    assert torch.equal(first.reduce, again.reduce)
    assert first.table.dtype == first.reduce.dtype == torch.int32
    table, reduce, n_slots = chunk_table(
        window_segments(sw, 7)[1].numpy(), 16)
    assert np.array_equal(first.table.numpy(), table)
    assert np.array_equal(first.reduce.numpy(), reduce)


@pytest.mark.parametrize("nw,t,num_sms,bm,bk,n", [
    (5, 900, 2, 16, 8, 24),    # every window split
    (9, 400, 1, 8, 16, 10),    # some windows empty, some split
    (3, 50, 132, 24, 8, 7),    # no window split
])
def test_partials_summed_in_chunk_order_match_unsplit(nw, t, num_sms, bm,
                                                      bk, n):
    rng = np.random.RandomState(nw * 100 + t)
    sw = rng.randint(0, nw, t).astype(np.int32)
    sw[sw == 1] = 0  # window 1 has no tiles
    sc = rng.randint(0, 6, t).astype(np.int32)
    fv = rng.randn(t, bm, bk).astype(np.float32)
    fv[rng.rand(t, bm, bk) < 0.9] = 0.0
    b = rng.randn(6 * bk, n).astype(np.float32)
    sw_t, sc_t, fv_t, b_t = (torch.from_numpy(x) for x in (sw, sc, fv, b))
    want = ref_block_stream_spmm(sw_t, sc_t, fv_t, b_t, nw)

    order, seg = window_segments(sw_t, nw)
    chunks = window_chunks(seg, num_sms=num_sms)
    partial = torch.zeros((chunks.n_slots, bm, n))
    out = torch.empty((nw * bm, n)).fill_(float("nan"))
    for w, first, end, slot in chunks.table.tolist():
        idx = order[first:end].long()
        part = ref_block_stream_spmm(
            torch.zeros_like(sw_t[idx]), sc_t[idx], fv_t[idx], b_t, 1)
        if slot < 0:
            out[w * bm:(w + 1) * bm] = part
        else:
            partial[slot] = part
    for w, s0, s1 in chunks.reduce.tolist():
        acc = torch.zeros((bm, n))
        for slot in range(s0, s1):
            acc = acc + partial[slot]
        out[w * bm:(w + 1) * bm] = acc
    assert not torch.isnan(out).any()
    assert not out.reshape(nw, bm, n)[1].any()
    err = (out - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item())


def test_library_path_tracks_shared_headers(tmp_path, monkeypatch):
    """A kernel source that includes a shared header is rebuilt when the
    header changes: the header's bytes are in every library's name."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "core.cuh"\n')
    (csrc / "core.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (csrc / "core.cuh").write_text("// v2\n")
    changed = _build.library_path("k")
    assert changed != before
    (csrc / "other.cuh").write_text("// new\n")
    assert _build.library_path("k") not in (before, changed)


def test_every_shipped_header_is_hashed():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert "tile_core.cuh" in headers
    for name in _build.SOURCES:
        assert _build.library_path(name).name.startswith(f"lib{name}-")


def test_failed_dense_tile_build_raises(tmp_path, monkeypatch):
    """dense_tile_spmm.cu failing to build raises from the wrapper before
    any index array is derived: an operand that is not on the CPU never
    reaches the plain version or the chunk table."""
    from repro_torch.kernels import dense_tile_spmm as dts

    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text(
        "#!/bin/sh\nout=''\nprev=''\nfor a in \"$@\"; do\n"
        "  [ \"$prev\" = -o ] && out=\"$a\"\n  prev=\"$a\"\ndone\n"
        "case \"$*\" in *dense_tile_spmm.cu*) "
        "echo \"error: simulated failure in $*\"; exit 1;; esac\n"
        ": > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})

    def never(*args, **kwargs):
        raise AssertionError("ran for a non-CPU operand")

    monkeypatch.setattr(dts, "ref_block_stream_spmm", never)
    monkeypatch.setattr(dts, "window_segments", never)
    monkeypatch.setattr(dts, "window_chunks", never)
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    t, bm, bk = 3, 16, 64
    steps = torch.zeros(t, **i32)
    before = dts.dense_tile_spmm.launches
    with pytest.raises(KernelLoweringError, match="dense_tile_spmm.cu"):
        dense_tile_spmm(steps, steps, torch.zeros(t, bm, bk, **meta),
                        torch.zeros(bk, 8, **meta), num_windows=1, bm=bm,
                        bk=bk)
    assert dts.dense_tile_spmm.launches == before
