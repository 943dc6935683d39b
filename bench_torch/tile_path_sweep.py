#!/usr/bin/env python3
"""The sweep that sets the tile core's density threshold (kMmaMinDensity in
``src/repro_torch/kernels/csrc/tile_core.cuh``) on one NVIDIA GPU.

    python3 bench_torch/tile_path_sweep.py [--out build/sweep.json]

Run from the root of a checkout.  It builds the kernels three times: as
they are, with every tile sent to the zero-skipping walk, and with every
tile sent to the 3xTF32 tensor-core product (the threshold constant
replaced in a copy of the sources, built into a directory of its own under
``build/``).  Then it times, with CUDA events, each build's

- ``dense_tile_spmm`` on one 4,096-tile stream (32 windows of 128 tiles,
  each window holding every k-block once; bm = 128, bk = 64, N = 256) at
  each tile density of DENSITIES, and
- ``nm_tile_spmm`` on 5,504 tiles (86 windows of 64, the Llama-2-7B MLP
  up-projection's plan) at each N:M pattern of PATTERNS, N = 2,048, and
- ``bitmap_tile_spmm`` on the same stream shape, its tiles drawn at each
  density of BITMAP_DENSITIES and packed as bitmaps, N = 2,048,

holds every result against the plain version (1e-4 * max(1, max|plain|))
and prints one JSON line per measurement, then the card's name and power
limit.  The crossover of the two forced builds is where the threshold
belongs.  It needs a card; without one it exits nonzero.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DENSITIES = (0.01, 0.025, 0.05, 0.075, 0.10, 0.125, 0.15, 0.20, 0.25, 0.50)
PATTERNS = ((1, 32), (1, 16), (2, 16), (1, 8), (2, 8), (4, 16), (2, 4))
BITMAP_DENSITIES = (0.01, 0.025, 0.05, 0.075, 0.10, 0.15, 0.25, 0.50)
CONSTANT = re.compile(r"(kMmaMinDensity\s*=\s*)([0-9.]+)f")
TOL = 1e-4


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the records to this JSON file")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tile_path_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.formats import pack_bitmap_tiles_torch, pack_nm_tiles
    from repro_torch.kernels import _build, dense_tile_spmm as dts, ref
    from repro_torch.kernels import structured_spmm as ss

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed_ms(fn, budget_ms=200.0):
        """Mean ms per call over back-to-back calls filling about
        ``budget_ms`` after a warm-up (at least 10 calls)."""
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
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        if not err <= TOL * scale:
            raise RuntimeError(f"max |diff| {err} > {TOL} * {scale}")
        return err

    # B1's stream: 32 windows of 128 tiles, every k-block once per window
    nw, per, n = 32, 128, 256
    sw = torch.arange(nw, device=dev, dtype=torch.int32).repeat_interleave(
        per)
    sc = torch.arange(per, device=dev, dtype=torch.int32).repeat(nw)
    b1_b = torch.randn((per * 64, n), generator=gen, device=dev)
    # the index arrays a plan caches, built once
    b1_segments = dts.window_segments(sw, nw)
    b1_chunks = dts.window_chunks(b1_segments[1])
    streams = {}
    for d in DENSITIES:
        vals = torch.randn((nw * per, 128, 64), generator=gen, device=dev)
        keep = torch.rand(vals.shape, generator=gen, device=dev) < d
        streams[d] = torch.where(keep, vals, torch.zeros((), device=dev))
    # B6's streams: the pruned-weight plan's shape, 86 windows of 64 tiles
    rng = np.random.RandomState(6)
    nm_sw = torch.arange(86, device=dev, dtype=torch.int32).repeat_interleave(
        64)
    nm_sc = torch.arange(64, device=dev, dtype=torch.int32).repeat(86)
    nm_b = torch.randn((64 * 64, 2048), generator=gen, device=dev)
    nm_segments = dts.window_segments(nm_sw, 86)
    packed = {}
    for n_pat, m_pat in PATTERNS:
        g = rng.randn(86 * 64, 128, 64 // m_pat, m_pat).astype(np.float32)
        keep = np.argsort(rng.rand(*g.shape), axis=-1) < n_pat
        vals, codes = pack_nm_tiles(
            np.where(keep, g, 0.0).reshape(-1, 128, 64), n_pat, m_pat)
        packed[(n_pat, m_pat)] = tuple(
            torch.from_numpy(x).to(dev) for x in (vals, codes))
        del g, keep
    bitmaps = {}
    for d in BITMAP_DENSITIES:
        vals = torch.randn((86 * 64, 128, 64), generator=gen, device=dev)
        keep = torch.rand(vals.shape, generator=gen, device=dev) < d
        bitmaps[d] = pack_bitmap_tiles_torch(
            torch.where(keep, vals, torch.zeros((), device=dev)))
        del vals, keep

    # every tile value above is finite: the flag a plan would hold for them
    # (plan_ir.unsplittable_flag), so no call reads its tiles to find it
    finite = torch.zeros(1, dtype=torch.int32, device=dev)
    src = _build.CSRC
    records = []
    for build, threshold in (("as is", None), ("walk", "2.0"),
                             ("mma", "0.0")):
        if threshold is not None:
            csrc = ROOT / "build" / f"sweep_csrc_{build}"
            shutil.rmtree(csrc, ignore_errors=True)
            shutil.copytree(src, csrc)
            header = csrc / "tile_core.cuh"
            text, count = CONSTANT.subn(rf"\g<1>{threshold}f",
                                        header.read_text())
            if count != 1:
                raise RuntimeError("threshold constant not found")
            header.write_text(text)
            _build.CSRC = csrc
        else:
            _build.CSRC = src
        _build._LIBS.clear()
        _build._FUNCS.clear()
        for d, fv in streams.items():
            def kern():
                return dts.dense_tile_spmm(sw, sc, fv, b1_b, num_windows=nw,
                                           bm=128, bk=64,
                                           segments=b1_segments,
                                           chunks=b1_chunks, a_flag=finite)
            err = check(kern(), ref.ref_block_stream_spmm(
                sw, sc, fv, b1_b, nw, tile_chunk=512))
            records.append({"kernel": "dense_tile_spmm", "build": build,
                            "density": d, "ms": timed_ms(kern),
                            "max_abs_err": err})
            print(json.dumps(records[-1]), flush=True)
        for (n_pat, m_pat), (vals, codes) in packed.items():
            def kern():
                return ss.nm_tile_spmm(nm_sw, nm_sc, vals, codes, nm_b,
                                       num_windows=86, bm=128, bk=64,
                                       n_pat=n_pat, m_pat=m_pat,
                                       segments=nm_segments, a_flag=finite)
            err = check(kern(), ref.ref_nm_stream_spmm(
                nm_sw, nm_sc, vals, codes, nm_b, 86, n_pat, m_pat, 64,
                tile_chunk=16))
            records.append({"kernel": "nm_tile_spmm", "build": build,
                            "pattern": f"{n_pat}:{m_pat}",
                            "density": n_pat / m_pat, "ms": timed_ms(kern),
                            "max_abs_err": err})
            print(json.dumps(records[-1]), flush=True)
        for d, (words, values, cap) in bitmaps.items():
            def kern():
                return ss.bitmap_tile_spmm(nm_sw, nm_sc, words, values, nm_b,
                                           num_windows=86, bm=128, bk=64,
                                           row_cap=cap, segments=nm_segments,
                                           a_flag=finite)
            err = check(kern(), ref.ref_bitmap_stream_spmm(
                nm_sw, nm_sc, words, values, nm_b, 86, 64, tile_chunk=128))
            records.append({"kernel": "bitmap_tile_spmm", "build": build,
                            "density": d, "row_cap": cap,
                            "ms": timed_ms(kern), "max_abs_err": err})
            print(json.dumps(records[-1]), flush=True)
    _build.CSRC = src
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi, "records": records}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
