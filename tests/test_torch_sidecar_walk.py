"""The delta sidecar's row orders keep a few padding entries, and the walk
over them is bit for bit the walk over every one, on the CPU.

A sidecar (``plan_ir.DeltaFringe``) is padded to its capacity with
(row 0, col 0, 0.0) entries, and its k-bucketed copy to ``capacity *
chunk`` entries, so the row order of either puts every padding entry in
packed row 0.  ``gather_spmm.sidecar_row_order`` cuts them with
``drop_padding``.  These tests emulate the card's walk in numpy, with the
grouping and step that ``csrc/gather_spmm.cu`` uses (read from the
source here): row position p feeds partial sum p % WALK_GROUPS, each
partial sum is a chain of fp32 FMAs in row order from +0, the slots of
the row's last step past its end add 0 * 0, and the partial sums are
added at the end.  Over the cut order and the full one it must give the
same bits, signed zeros from underflowing products and NaN from an Inf or
a NaN that a padding entry reads included.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.plan_ir import SpmmConfig, build_delta_fringe
from repro_torch.kernels.gather_spmm import (
    WALK_GROUPS, WALK_STEP, RowOrder, drop_padding, kbucket_row_order,
    sidecar_row_order, stream_row_order,
)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "gather_spmm.cu")


def test_walk_constants_match_the_kernel_source():
    text = SOURCE.read_text()
    slice_cols = int(re.search(r"kDefaultSlice = (\d+);", text).group(1))
    unroll = int(re.search(r"kDefaultUnroll = (\d+);", text).group(1))
    groups = 32 // min(slice_cols // 4, 32)
    assert (WALK_GROUPS, WALK_STEP) == (groups, groups * unroll)


def _fma(v, x, acc):
    """fp32 fma: the exact product (48 bits fit a double) plus acc, rounded
    once more to fp32; the sign of a zero follows IEEE addition."""
    with np.errstate(invalid="ignore", over="ignore"):
        return (np.float64(v) * x.astype(np.float64)
                + acc.astype(np.float64)).astype(np.float32)


def _walk_row(cols, vals, b):
    """The kernel's sum of one row, for every column of ``b``."""
    acc = np.zeros((WALK_GROUPS, b.shape[1]), np.float32)
    length = len(cols)
    for p in range(-(-length // WALK_STEP) * WALK_STEP):
        if p < length:
            v, x = np.float32(vals[p]), b[cols[p]]
        else:  # the last step's slots past the end
            v, x = np.float32(0.0), np.zeros(b.shape[1], np.float32)
        acc[p % WALK_GROUPS] = _fma(v, x, acc[p % WALK_GROUPS])
    out = acc[0]
    for g in range(1, WALK_GROUPS):
        out = out + acc[g]
    return out


def _row0(order, vals):
    end = int(order.indptr[1])
    perm = order.perm[:end].long()
    return order.cols[:end].numpy(), vals[perm].numpy()


def _same_bits(x, y):
    nan = np.isnan(x)
    assert np.array_equal(nan, np.isnan(y))
    assert np.array_equal(x[~nan].view(np.uint32), y[~nan].view(np.uint32))


def _hard_b(rng, k, n, inf_rows=()):
    """Values of every sign, exact zeros of both signs, and tiny ones whose
    products underflow to a signed zero."""
    b = rng.randn(k, n).astype(np.float32)
    b[rng.rand(k, n) < 0.2] = 0.0
    b[rng.rand(k, n) < 0.2] = -0.0
    tiny = rng.rand(k, n) < 0.3
    b[tiny] = (np.sign(rng.randn(int(tiny.sum()))) * 1e-30).astype(
        np.float32)
    for r in inf_rows:
        b[r, rng.randint(n)] = np.inf
    return b


@pytest.mark.parametrize("seed", range(40))
def test_drop_padding_keeps_every_bit_of_row_0(seed):
    """Random row-0 layouts: real entries (tiny values, signed zeros)
    between runs of padding entries that read several B rows, B with
    signed zeros, underflowing products and sometimes an Inf."""
    rng = np.random.RandomState(seed)
    k, n = 40, 6
    n_real = rng.randint(0, 6)
    runs = [rng.randint(0, 30) for _ in range(n_real + 1)]
    runs[-1 - seed % (n_real + 1)] += 1   # some padding in every draw
    cols, vals, pad = [], [], []
    for i in range(n_real + 1):
        if runs[i]:
            run_cols = rng.choice([0, 8, 16, 24], size=runs[i])
            cols += list(run_cols)
            vals += [0.0] * runs[i]
            pad += [True] * runs[i]
        if i < n_real:
            cols.append(rng.randint(k))
            vals.append(rng.choice([1e-30, -1e-30, -0.0, 0.0, 1.5, -2.0]))
            pad.append(False)
    # row 0 as drawn, then two real rows
    cols += [1, 2, 3]
    vals += [1.0, 2.0, 3.0]
    pad += [False] * 3
    l0 = len(cols) - 3
    order = RowOrder(torch.arange(len(cols), dtype=torch.int32),
                     torch.tensor([0, l0, l0 + 1, l0 + 3], dtype=torch.int32),
                     torch.tensor(cols, dtype=torch.int32))
    vt = torch.tensor(vals, dtype=torch.float32)
    cut = drop_padding(order, np.array(pad))
    assert torch.equal(cut.perm[int(cut.indptr[1]):], order.perm[l0:])
    assert torch.equal(cut.indptr[1:] - cut.indptr[1], order.indptr[1:] - l0)
    kept = np.array(pad)[cut.perm[:int(cut.indptr[1])].long().numpy()]
    assert kept.sum() <= (n_real + 1) * 4 * WALK_GROUPS + WALK_STEP * (
        n_real + 1)
    for b in (_hard_b(rng, k, n), _hard_b(rng, k, n, inf_rows=(8,)),
              _hard_b(rng, k, n, inf_rows=(0, 24))):
        _same_bits(_walk_row(*_row0(cut, vt), b),
                   _walk_row(*_row0(order, vt), b))


TIER_BUDGET = {"resident": None, "ksharded": 400 * 256 * 4}


@pytest.mark.parametrize("tier", ["resident", "ksharded"])
def test_sidecar_row_order_walks_a_few_pads(tier):
    """The row orders of a sidecar (B2's over the packed stream, B3's over
    its k-bucketed copy): every row but packed row 0 as in the full order,
    row 0 holding only a few of its padding entries (on the packed stream
    one, more only to keep the row's length modulo ``WALK_STEP``), and the
    walk of row 0 bit for bit the full walk's, with an Inf in B's row 0
    too."""
    rng = np.random.RandomState(7)
    shape = (300, 3000)
    key = np.sort(rng.choice(shape[0] * shape[1], 150, replace=False))
    # packed row 0 reaches several k-blocks on the k-bucketed form
    key[:4] = [0, 700, 1500, 2900]
    key = np.unique(key)
    cfg = SpmmConfig(impl="cuda", fringe_vmem_budget=TIER_BUDGET[tier])
    df = build_delta_fringe(key // shape[1], key % shape[1],
                            rng.randn(key.size), shape, cfg, device="cpu")
    assert df.tier == tier and df.count < df.capacity
    rows, cols, vals, _gsrc, kbc, kbr, kbcol, kbv = df.leaves
    cap = df.capacity
    if tier == "ksharded":
        full = kbucket_row_order(kbc, kbr, kbcol, cap, df.bk)
        cut = sidecar_row_order(rows, cols, cap, kb_chunk=kbc, kb_rows=kbr,
                                kb_cols=kbcol, bk=df.bk)
        v = kbv
        n_pad = kbr.numel() - df.count
    else:
        full = stream_row_order(rows, cols, cap)
        cut = sidecar_row_order(rows, cols, cap)
        v = vals
        n_pad = cap - df.count
    end_full, end_cut = int(full.indptr[1]), int(cut.indptr[1])
    assert torch.equal(cut.perm[end_cut:], full.perm[end_full:])
    assert torch.equal(cut.cols[end_cut:], full.cols[end_full:])
    assert torch.equal(cut.indptr[1:] - end_cut, full.indptr[1:] - end_full)
    real0 = int((key < shape[1]).sum())   # packed row 0's real entries
    kept = end_cut - real0
    assert end_full - real0 == n_pad
    if tier == "resident":
        # one column (B's row 0): one entry, more only to keep the row's
        # length modulo the walk's step
        assert 1 <= kept <= WALK_STEP
        assert (kept - n_pad) % WALK_STEP == 0
    else:
        # each run of padding keeps, per partial sum, one entry for each B
        # row its padding reads: the first row of each k-block
        nkb = -(-shape[1] // df.bk)
        assert kept <= (real0 + 1) * (WALK_GROUPS * nkb + WALK_STEP)
        assert 10 * kept < n_pad
    for inf in (False, True):
        b = _hard_b(rng, shape[1], 24, inf_rows=(0,) if inf else ())
        got = _walk_row(*_row0(cut, v), b)
        _same_bits(got, _walk_row(*_row0(full, v), b))
        assert bool(np.isnan(got).any()) == inf
