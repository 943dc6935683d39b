#!/usr/bin/env python3
"""The sweep that chose gather_spmm's design constants (kDefaultSlice and
kDefaultUnroll in ``src/repro_torch/kernels/csrc/gather_spmm.cu``) and
gather_sddmm's (kSliceCols, kUnrollLoads and the streaming cache hint in
``src/repro_torch/kernels/csrc/sddmm.cu``) on one NVIDIA GPU,
with gather_spmm_ksharded's two forms beside them.

    python3 bench_torch/gather_sweep.py [--out build/gather_sweep.json]

Run from the root of a checkout.  It builds the kernels, then draws a
packed fringe at the shape of the reddit-scale plan's (226,821 rows, about
34.6 M nonzeros over B's 232,965 rows, N = 256): row lengths from the
graph generator's law for Reddit (Pareto 1.05, mean degree 492, seed 10)
with its 6,144 longest rows left out (the tile band takes them), columns
from its law ``k * power(0.3)``, duplicates removed.  On it, with CUDA
events, it times

- ``gather_spmm`` as committed, and every (slice width, unroll depth) of
  VARIANTS through ``gather_spmm_variant_launch``, each held against the
  plain version (1e-4 * max(1, max|plain|));
- ``gather_spmm_ksharded`` on the same fringe bucketed for the k-sharded
  tier (bk = 2048, chunks of 8, as ``prepare`` pads them): as committed
  (its values gathered into the row-major order by its own kernel, then
  the walk), and with that gather done by PyTorch's ``index_select``
  instead; each held against ``ref_gather_spmm_kblocked``;
- ``torch.sparse.mm`` on the CSR of the same fringe (the library call);
- ``gather_sddmm`` (the SDDMM fringe's row walk) on the same fringe as
  the committed kernel, and every (slice width, unroll depth) of
  SDDMM_VARIANTS with and without the streaming hint through
  ``gather_sddmm_variant_launch``, with X (226,821
  x 256) and Y^T (232,965 x 256) seeded and each dot written at its
  position in a row-sorted COO whose every entry is on the fringe; each
  held against the plain version;
- the gather-bandwidth probe (``gather_probe_launch``): as many 1 KB rows
  as the fringe has nonzeros, read at random from the first 23,437 rows of
  B (24 MB, which fits in L2) and from all of B (238 MB).

It prints the fringe's row and column statistics and one JSON line per
measurement, then the card's name and power limit.  It needs a card;
without one it exits nonzero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (slice width, unroll depth) pairs the variant entry point builds
VARIANTS = ((16, 2), (16, 4), (32, 2), (32, 4), (32, 8), (64, 2), (64, 4),
            (64, 8), (128, 2), (128, 4), (128, 8), (256, 2), (256, 4),
            (256, 8))
# (slice width, unroll depth) pairs gather_sddmm_variant_launch builds,
# each with and without the streaming hint
SDDMM_VARIANTS = tuple((s, u) for s in (32, 64, 128, 256) for u in (4, 8))
TOL = 1e-4
# the reddit-scale plan (PERF.md section 5)
M = K = 232965
BAND_ROWS = 6144
N = 256
L2_SET_BYTES = 24 * 10 ** 6
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reddit_like_fringe(seed: int = 10, m: int = M, k: int = K,
                       avg_degree: float = 492.0, skew: float = 1.05,
                       band_rows: int = BAND_ROWS):
    """Row-sorted unique (rows, cols) of a fringe drawn as described in the
    module docstring, as int32 numpy arrays, and its row count."""
    import numpy as np

    from repro_torch.core.arrays import sorted_unique

    rng = np.random.RandomState(seed)
    deg = rng.pareto(skew, m) + 1.0
    deg = np.maximum(np.minimum(deg / deg.mean() * avg_degree, k)
                     .astype(np.int64), 1)
    deg = np.sort(deg)[:m - band_rows]
    rng.shuffle(deg)
    rows = np.repeat(np.arange(deg.size, dtype=np.int64), deg)
    cols = (k * rng.power(0.3, rows.size)).astype(np.int64) % k
    key = sorted_unique(rows * k + cols)
    return ((key // k).astype(np.int32), (key % k).astype(np.int32),
            int(deg.size))


def variant_fn():
    from repro_torch.kernels import _build

    return _build.function("gather_spmm", "gather_spmm_variant_launch",
                           (_P,) * 5 + (_I,) * 4 + (_P,))


def gather_probe(b, set_rows: int, reads: int, timed_ms, seed: int = 1):
    """ms of the gather-bandwidth probe: ``reads`` 1 KB rows of ``b`` (a
    contiguous (>= set_rows, n >= 256) fp32 tensor on the card) at random
    below ``set_rows``.  Raises if the launch fails."""
    import torch

    from repro_torch.kernels import _build

    fn = _build.function("gather_spmm", "gather_probe_launch",
                         (_P, _I, _I, _L, _I, _P, _I, _P))
    blocks = 8 * torch.cuda.get_device_properties(
        b.device).multi_processor_count
    sink = torch.empty(blocks * 256, device=b.device)

    def run():
        status = fn(b.data_ptr(), b.shape[1], set_rows, reads, seed,
                    sink.data_ptr(), blocks,
                    torch.cuda.current_stream(b.device).cuda_stream)
        _build.check_status(status, "gather_probe")

    return timed_ms(run)


def sddmm_variant_fn():
    """gather_sddmm_variant_launch of the built sddmm library."""
    from repro_torch.kernels import _build

    return _build.function(
        "sddmm", "gather_sddmm_variant_launch",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P))


def sddmm_records(rows, cols, num_rows, gen, timed_ms, check, record):
    """Time gather_sddmm as committed and every SDDMM_VARIANTS choice,
    with and without the streaming hint, on the fringe ``rows``/``cols``
    (row-sorted, on the card), each held against the plain version."""
    import torch

    from repro_torch.core.plan_ir import fringe_row_order
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.sddmm import gather_sddmm

    dev = rows.device
    nnz = rows.numel()
    pos = torch.arange(nnz, device=dev, dtype=torch.int32)
    walk = fringe_row_order(rows, cols, pos, num_rows)
    x = torch.randn((num_rows, N), generator=gen, device=dev)
    yt = torch.randn((K, N), generator=gen, device=dev)
    want = ref.ref_gather_sddmm(rows, cols, pos, x, yt,
                                torch.empty(nnz, device=dev), chunk=1 << 21)
    out = torch.empty(nnz, device=dev)

    def committed():
        return gather_sddmm(*walk, x, yt, out)

    record(kernel="gather_sddmm", variant="committed", d=N,
           ms=timed_ms(committed), max_abs_err=check(committed(), want))
    fn = sddmm_variant_fn()
    acc = torch.empty(nnz, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for s, u in SDDMM_VARIANTS:
        for hint in (1, 0):
            def run(s=s, u=u, hint=hint):
                status = fn(*(t.data_ptr() for t in (*walk, x, yt, out, acc)),
                            num_rows, N, s, u, hint, stream)
                _build.check_status(status, "gather_sddmm variant")
                return out
            record(kernel="gather_sddmm", slice=s, unroll=u,
                   streaming_hint=bool(hint), d=N, ms=timed_ms(run),
                   max_abs_err=check(run(), want))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the records to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gather_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref
    from repro_torch.core.plan_ir import bucket_fringe_kblocks
    from repro_torch.kernels.gather_spmm import (
        csr_indptr, fringe_profile, gather_spmm, gather_spmm_ksharded,
        kbucket_row_order,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()

    def timed_ms(fn, budget_ms=300.0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        reps = int(max(5, budget_ms // max(start.elapsed_time(end), 1e-3)))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def check(got, want):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        if not err <= TOL * scale:
            raise RuntimeError(f"max |diff| {err} > {TOL} * {scale}")
        return err

    rows_np, cols_np, num_rows = reddit_like_fringe()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, cols = (torch.from_numpy(x).to(dev) for x in (rows_np, cols_np))
    vals = torch.randn(rows.numel(), generator=gen, device=dev)
    b = torch.randn((K, N), generator=gen, device=dev)
    indptr = csr_indptr(rows, num_rows)
    profile = fringe_profile(indptr, cols, K)
    print(json.dumps({"fringe": profile}), flush=True)
    nnz = rows.numel()
    want = ref.ref_gather_spmm(rows, cols, vals, b, num_rows, chunk=1 << 21)
    records = []

    def record(**rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def committed():
        return gather_spmm(rows, cols, vals, b, num_rows=num_rows,
                           indptr=indptr)

    record(kernel="gather_spmm", variant="committed",
           ms=timed_ms(committed), max_abs_err=check(committed(), want))
    fn = variant_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((num_rows, N), device=dev)
    for s, u in VARIANTS:
        def run(s=s, u=u):
            status = fn(indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                        b.data_ptr(), out.data_ptr(), num_rows, N, s, u,
                        stream)
            _build.check_status(status, "gather_spmm variant")
            return out
        record(kernel="gather_spmm", slice=s, unroll=u, ms=timed_ms(run),
               max_abs_err=check(run(), want))
    # the k-sharded tier's two forms on the same fringe
    bk = 2048
    kb = bucket_fringe_kblocks(rows_np, cols_np, vals.cpu().numpy(),
                               -(-K // bk) * bk, bk, 8)
    kbc, kbr, kbcol, kbv = (torch.from_numpy(x).to(dev) for x in kb[:4])
    del kb
    order = kbucket_row_order(kbc, kbr, kbcol, num_rows, bk)
    want_kb = ref.ref_gather_spmm_kblocked(kbc, kbr, kbcol, kbv, b,
                                           num_rows, bk, step=1 << 21)
    for form, run in (
            ("committed",
             lambda: gather_spmm_ksharded(kbc, kbr, kbcol, kbv, b,
                                          num_rows=num_rows, bk=bk,
                                          row_order=order)),
            ("values gathered by index_select, then the walk",
             lambda: gather_spmm(order.cols, order.cols,
                                 kbv.index_select(0, order.perm), b,
                                 num_rows=num_rows, indptr=order.indptr))):
        record(kernel="gather_spmm_ksharded", form=form, bk=bk,
               entries=kbr.numel(), ms=timed_ms(run),
               max_abs_err=check(run(), want_kb))
    del kbc, kbr, kbcol, kbv, order, want_kb
    crow = indptr.long()
    csr = torch.sparse_csr_tensor(crow, cols.long(), vals, (num_rows, K))
    record(kernel="torch.sparse.mm (CSR)", ms=timed_ms(
        lambda: torch.sparse.mm(csr, b)))
    del csr
    sddmm_records(rows, cols, num_rows, gen, timed_ms, check, record)
    l2_rows = L2_SET_BYTES // (4 * N)
    for label, set_rows in (("L2 (24 MB set)", l2_rows),
                            ("HBM (238 MB set)", K)):
        ms = gather_probe(b, set_rows, nnz, timed_ms)
        record(kernel="gather_probe", set=label, rows=set_rows, reads=nnz,
               ms=ms, gb_per_s=nnz * 4 * N / ms / 1e6)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi, "fringe": profile, "records": records},
            indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
