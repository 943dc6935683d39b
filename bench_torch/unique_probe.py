"""Time ``np.unique`` against ``core.arrays.sorted_unique`` on graph keys.

numpy 2.3 finds the distinct values of an integer array with a hash table
(``_unique_hash``) and sorts them after; earlier releases sort first.  The
probe draws ``--n`` int64 keys of a Reddit-size graph (uniform in
``[0, 232965**2)``, seeded), times both functions on them once each, and
checks that they agree.  It needs no card; run it on the host that runs
``chip_smoke.py``:

    python3 bench_torch/unique_probe.py --n 85000000

It prints numpy's version, the card's name and power limit where
``nvidia-smi`` answers, and one JSON line with the seconds.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REDDIT_NODES = 232965


def main(argv=None) -> int:
    import numpy as np

    from repro_torch.core.arrays import sorted_unique

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=85_000_000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = "no nvidia-smi"
    print(f"numpy {np.__version__}; {smi}", flush=True)
    keys = np.random.RandomState(args.seed).randint(
        0, REDDIT_NODES * REDDIT_NODES, args.n).astype(np.int64)
    t0 = time.perf_counter()
    want = np.unique(keys)
    t_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = sorted_unique(keys)
    t_sort = time.perf_counter() - t0
    same = bool(np.array_equal(got, want))
    print(json.dumps({"unique_probe": {
        "n": args.n, "distinct": int(want.size), "np_unique_s": t_np,
        "sorted_unique_s": t_sort, "equal": same,
        "numpy": np.__version__}}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
