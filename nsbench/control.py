"""The control: the plain reference put in the program's place, computed
from TF32-rounded operands (the precision just below the configuration's
float32 with TF32 off), read by the same numbers the cell's check
compares, on the cell's own inputs at its own size.  Its readings have to
fail the cell's limits; ``limits/<cell>.json`` is set between the
program's readings and these.  Each kind gives its own (``control`` in
``kinds/<kind>.py``).  The benchmark's runs never run it.

    python3 nsbench/control.py --workload reddit.spmm --seeds 11,12,13 \\
        --out build/control.reddit.spmm.json

On the card where there is one, else on the CPU (at a test's size).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nsbench.harness import Bench  # noqa: E402


def control_readings(bench: Bench, workload: str, seeds: List[int],
                     device: torch.device) -> List[Dict[str, float]]:
    _, cfg, mix, kind = bench.setting(workload)
    return [kind.control(bench, cfg, mix, s, device) for s in seeds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent
    bench = Bench.load(root.parent / "BENCHMARK.json", root)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    limits = bench.limits(args.workload)
    t0 = time.perf_counter()
    readings = control_readings(bench, args.workload, seeds, device)
    out = {"workload": args.workload, "device": str(device),
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "seeds": seeds, "readings": readings, "limits": limits,
           "fails_a_limit": [any(r[k] > limits[k] for k in limits)
                             for r in readings],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
