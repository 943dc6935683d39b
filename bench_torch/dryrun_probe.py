#!/usr/bin/env python3
"""``chip_smoke.py``'s dry run against the card (phase 13) alone, on one
NVIDIA GPU.

    python3 bench_torch/dryrun_probe.py

Run from the root of a checkout.  It runs ``chip_smoke.dryrun_path``:
``launch.dryrun.run_cell`` on the ``meta`` device for ``qwen1.5-4b``'s
train cell on a 1 x 1 mesh (8 x 128 tokens, 2 microbatches, remat full,
the cell's bf16 moments), then one step of the same cell on the card under
``FlopCounterMode`` and one under the profiler, then rank 0 of the same
cell partitioned over a 1 x 2 (data x model) mesh, traced and stepped on
the card under a ``fake`` process group, then the same for
``granite-moe-3b-a800m``'s train cell (the dense MoE) on a 2 x 1 mesh (see
its docstring for the checks).  The path builds no kernel.  It prints the
card's ``memory.total``, one JSON line with the path's numbers, then the
card's name and power limit.  It needs a card; without one it exits
nonzero.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dryrun_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke as cs

    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"memory.total {smi('memory.total')}")
    out = cs.dryrun_path(cs.standalone_context())
    cs.log(json.dumps({"dryrun": out}))
    cs.log(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
