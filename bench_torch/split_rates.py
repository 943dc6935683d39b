#!/usr/bin/env python3
"""The rates that price the engine split of ``impl="cuda"`` plans
(``H100_*`` in ``src/repro_torch/core/cost_model.py``), on one NVIDIA GPU.

    python3 bench_torch/split_rates.py [--out build/split_rates.json]
        [--skip-tiles] [--skip-reddit] [--row-alphas 0.03 0.064 ...]

Run from the root of a checkout; N = 256 throughout.  Two phases:

- ``tiles``: ``dense_tile_spmm`` (B1) alone, CUDA-event timed, on streams
  of 8 windows that each hold every k-block of a Reddit-sized K (232,965
  rows of B, 3,641 k-blocks of 64; 29,128 tiles of 128 x 64), the tiles
  drawn at each density of DENSITIES.  B1 takes the zero-skipping walk
  below ``kMmaMinDensity`` and the 3xTF32 product at or above it, so the
  sweep prices both tiers: ns a tile, and on the walk a least-squares
  line of ns against the tile's nonzeros.
- ``plans``: the ogbn-arxiv and Reddit graphs of the benchmark's
  configurations (``nsbench/configs``; the generators under
  ``nsbench/generators``), planned by ``sparse.from_coo`` with the default
  split, then ``sparse.spmm`` under ``torch.profiler``: each kernel's
  device time a call, the plan's stats, B1's ns a tile and the row walk's
  (B2/B3, ``gather_rows_kernel``) nonzeros a second, beside what the
  model (``EngineCostModel.analytic_h100``) predicts for the two paths.

Every result is held against the plain version (1e-4 * max(1, max|plain|))
on the tile streams and against ``torch.sparse.mm`` on the plans.  Prints
one JSON line per measurement, then the card's name and power limit.  It
needs a card; without one it exits nonzero.  ``--skip-tiles`` and
``--skip-reddit`` leave out the tiles phase and the Reddit plan (its
``prepare`` takes about a minute of host time); ``--row-alphas`` plans
each graph again with the row stage at each given alpha, the windows
priced by the model's rates as ever.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DENSITIES = (0.002, 0.005, 0.01, 0.02, 0.03, 0.04, 0.049,
             0.05, 0.065, 0.08, 0.1, 0.13, 0.2, 0.3, 0.5)
REDDIT_K = 232965
WINDOWS = 8
N = 256
TOL = 1e-4
REPS = 20


def timed_ms(fn, budget_ms=300.0):
    """Mean ms a call over back-to-back calls filling about ``budget_ms``
    after a warm-up (at least 10 calls), by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(max(10, budget_ms // max(start.elapsed_time(end), 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(got, want):
    """max |got - want|, raising above TOL * max(1, max|want|)."""
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not err <= TOL * scale:
        raise RuntimeError(f"max |diff| {err} > {TOL} * {scale}")
    return err


def tile_rates(dev, gen, emit):
    """B1's ns a tile at each density of DENSITIES (see the module's
    docstring), then the line of the walk tier and the product's median."""
    import numpy as np
    import torch

    from repro_torch.core.cost_model import H100_MMA_MIN_DENSITY
    from repro_torch.kernels import dense_tile_spmm as dts, ref

    nkb = (REDDIT_K + 63) // 64
    tiles = WINDOWS * nkb
    sw = torch.arange(WINDOWS, device=dev,
                      dtype=torch.int32).repeat_interleave(nkb)
    sc = torch.arange(nkb, device=dev, dtype=torch.int32).repeat(WINDOWS)
    b = torch.randn((nkb * 64, N), generator=gen, device=dev)
    segments = dts.window_segments(sw, WINDOWS)
    chunks = dts.window_chunks(segments[1])
    finite = torch.zeros(1, dtype=torch.int32, device=dev)
    walk_pts = []
    mma_ns = []
    for d in DENSITIES:
        keep = torch.rand((tiles, 128, 64), generator=gen, device=dev) < d
        fv = torch.randn((tiles, 128, 64), generator=gen, device=dev)
        fv = torch.where(keep, fv, torch.zeros((), device=dev))
        del keep
        nnz = torch.count_nonzero(fv).item() / tiles

        def kern():
            return dts.dense_tile_spmm(sw, sc, fv, b, num_windows=WINDOWS,
                                       bm=128, bk=64, segments=segments,
                                       chunks=chunks, a_flag=finite)
        # the plain version one window at a time (its dense tiles would not
        # fit the card at once)
        got = kern()
        for w in range(WINDOWS):
            sl = slice(w * nkb, (w + 1) * nkb)
            check(got[w * 128:(w + 1) * 128], ref.ref_block_stream_spmm(
                sw[sl] - w, sc[sl], fv[sl], b, 1, tile_chunk=512))
        del got
        ns = timed_ms(kern) * 1e6 / tiles
        tier = "mma" if nnz >= H100_MMA_MIN_DENSITY * 128 * 64 else "walk"
        (mma_ns.append(ns) if tier == "mma" else walk_pts.append((nnz, ns)))
        emit({"phase": "tiles", "density": d, "tile_nnz": nnz,
              "tier": tier, "tiles": tiles, "ns_per_tile": ns})
        del fv
    slope, intercept = np.polyfit([p[0] for p in walk_pts],
                                  [p[1] for p in walk_pts], 1)
    emit({"phase": "tiles_fit", "walk_ns_per_tile": float(intercept),
          "walk_ns_per_nnz": float(slope),
          "mma_ns_per_tile_median": float(np.median(mma_ns)),
          "mma_ns_per_tile_max": float(np.max(mma_ns))})
    del b, sw, sc, segments, chunks
    torch.cuda.empty_cache()


def plan_record(name, rows, cols, vals, shape, dev, gen, row_alpha=None):
    """Plan the graph with ``analytic_h100`` (its row stage at
    ``row_alpha`` where given, the windows priced by the model's rates
    either way), check one call against ``torch.sparse.mm`` and time the
    kernels of ``REPS`` more under ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import sparse as sp
    from repro_torch.core import spmm as core_spmm
    from repro_torch.core.cost_model import EngineCostModel
    from repro_torch.core.plan_ir import SpmmConfig

    model = EngineCostModel.analytic_h100()
    cm = (model if row_alpha is None else dataclasses.replace(
        model, p_matrix=model.p_vector / row_alpha))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    a = sp.from_plan(core_spmm.prepare(rows, cols, vals, shape, SpmmConfig(),
                                       cm, device=dev))
    prepare_s = time.perf_counter() - t0
    stats = a.plan.stats_dict
    bb = torch.randn((shape[1], N), generator=gen, device=dev)
    out = sp.spmm(a, bb)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    csr = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, cols])).to(dev),
        torch.from_numpy(np.asarray(vals, np.float32)).to(dev),
        shape).coalesce().to_sparse_csr()
    err = check(out, torch.sparse.mm(csr, bb))
    del csr, out
    ms = timed_ms(lambda: sp.spmm(a, bb))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            sp.spmm(a, bb)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        # device time of kernels and copies; the program's ranges repeat it
        if t > 0 and not e.key.startswith(("repro_torch.", "aten::",
                                           "Activity")):
            kernels[e.key[:80]] = t / REPS / 1e3  # ms a call
    b1 = sum(v for k, v in kernels.items() if "dense_tile_spmm_kernel" in k)
    walk = sum(v for k, v in kernels.items() if "gather_rows_kernel" in k)
    core = bool(stats["core_nnz"])
    tile_nnz = (torch.count_nonzero(a.plan.flat_values, dim=(1, 2))
                .cpu().numpy() if core else np.zeros(0))
    return {
        "phase": "plans", "graph": name, "nnz": int(rows.size),
        "row_alpha": row_alpha, "prepare_s": prepare_s,
        "stats": {k: stats.get(k) for k in (
            "alpha", "num_windows", "num_steps", "tile_density", "core_nnz",
            "fringe_nnz", "fringe_fraction", "fringe_tier",
            "windows_to_fringe", "matrix_format")},
        "stream_gb": stats["num_steps"] * 128 * 64 * 4 / 1e9 if core else 0.0,
        "longest_fringe_row": int(
            a.plan.fringe_rows.long().bincount().max().item()),
        "ms_per_call": ms,
        "gflops": 2.0 * rows.size * N / (ms * 1e-3) / 1e9,
        "device_ms_per_call": sum(kernels.values()),
        "kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
        "b1_ms": b1, "walk_ms": walk,
        "b1_ns_per_tile": b1 * 1e6 / stats["num_steps"] if core else None,
        "walk_nnz_per_s": (stats["fringe_nnz"] / (walk * 1e-3)
                           if walk else None),
        "model_b1_ms": float(model.tile_seconds(tile_nnz,
                                                128 * 64).sum() * 1e3),
        "model_walk_ms": stats["fringe_nnz"] / model.p_vector * 1e3,
        "memory_peak_gb": peak, "max_abs_err": err,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the records to this JSON file")
    parser.add_argument("--skip-tiles", action="store_true",
                        help="leave out the tiles phase")
    parser.add_argument("--skip-reddit", action="store_true",
                        help="leave the Reddit plan out of the plans phase")
    parser.add_argument("--row-alphas", type=float, nargs="*", default=(),
                        help="also plan each graph with its row stage at "
                             "these alphas (the windows priced as ever)")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("split_rates.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from nsbench.generators import chung_lu, sbm

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    if not args.skip_tiles:
        tile_rates(dev, gen, emit)
    graphs = [("ogbn-arxiv", sbm)]
    if not args.skip_reddit:
        graphs.append(("reddit", chung_lu))
    for name, module in graphs:
        cfg = json.loads((ROOT / "nsbench" / "configs" /
                          f"{name}.json").read_text())["graph"]
        rows, cols, vals, shape, _ = module.build(cfg, dev)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        if vals is None:
            vals = np.random.RandomState(0).randn(rows.size).astype(
                np.float32)
        for row_alpha in (None, *args.row_alphas):
            emit(plan_record(name, rows, cols, vals, shape, dev, gen,
                             row_alpha))
        del rows, cols, vals

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi, "records": records}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
