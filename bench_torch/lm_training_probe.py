#!/usr/bin/env python3
"""``chip_smoke.py``'s LM training path (phase 12) alone, on one NVIDIA GPU.

    python3 bench_torch/lm_training_probe.py [--no-split-compare]

Run from the root of a checkout.  It runs ``chip_smoke.lm_training_path``:
``qwen1.5-4b`` and ``granite-moe-3b-a800m`` at full width and depth, each
4 steps through ``TrainController`` (batch 8 x 128, 2 microbatches,
remat full, AdamW with fp32 moments), then the phase's checks (remat
against none bit for bit, five families' smoke configs on the card against
the CPU, the restart drill, ``examples/lm_training.py`` at its defaults;
see its docstring).  Unless ``--no-split-compare``, it also compares one
forward and backward of qwen at full size with the stacked leaves split by
``torch.unbind`` (the port's) and by indexing each group (profiler times,
wall, peak memory).  The path builds no kernel.  It prints one JSON line
with the path's numbers, then the card's name and power limit.  It needs
a card; without one it exits nonzero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-split-compare", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lm_training_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke as cs

    ctx = cs.standalone_context()
    out = cs.lm_training_path(ctx, split_compare=not args.no_split_compare)
    cs.log(json.dumps({"lm_training": out}))
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
