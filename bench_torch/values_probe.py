#!/usr/bin/env python3
"""``SparseMatrix.with_values`` at Reddit scale on one NVIDIA GPU: what a
value update of every nonzero costs, as UniMP's attention calls it once a
head.

    python3 bench_torch/values_probe.py [--src SRC] [--calls 5]
        [--out build/values_probe.json]

Run from the root of a checkout.  ``--src`` names the ``src`` directory
whose ``repro_torch`` is timed (default: this checkout's), so that two
checkouts are compared by running it twice in one call.  The graph is the
benchmark's ``reddit-gnn`` configuration (``nsbench/configs``: Reddit's
Chung-Lu stand-in with the diagonal, 114,848,857 nonzeros), planned by
``sparse.from_coo``.  New values are drawn on the card, as the edge
softmax leaves them.  Per call: the synchronised wall ms of
``A.with_values(values)`` and its device ms by CUDA events; the first
call (which builds what a structure keeps) apart.  Prints one JSON line,
with the card's name and power limit; exits nonzero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("values_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import repro_torch.sparse as sp
    from nsbench.harness import Bench

    dev = torch.device("cuda")
    bench = Bench.load(ROOT / "BENCHMARK.json", ROOT / "nsbench")
    cfg = bench.config("reddit-gnn")
    g = cfg["graph"]
    rows, cols, vals, shape, _ = bench.generator(g["generator"]).build(g, dev)
    t0 = time.perf_counter()
    a = sp.from_coo(rows, cols, vals, shape, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(7)
    rec = []
    for i in range(args.calls + 1):
        new = torch.rand(rows.size, generator=gen, device=dev)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        b = a.with_values(new)
        ev1.record()
        torch.cuda.synchronize()
        rec.append({"wall_ms": 1e3 * (time.perf_counter() - t0),
                    "device_ms": ev0.elapsed_time(ev1)})
        del b
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"src": args.src, "card": smi, "nnz": int(rows.size),
           "prepare_s": prepare_s, "first_call": rec[0], "calls": rec[1:],
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
