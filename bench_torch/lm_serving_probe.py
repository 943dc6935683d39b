#!/usr/bin/env python3
"""``chip_smoke.py``'s LM serving path (phase 11) alone, on one NVIDIA GPU.

    python3 bench_torch/lm_serving_probe.py

Run from the root of a checkout.  It runs ``chip_smoke.lm_serving_path``:
``qwen1.5-4b`` and ``granite-moe-3b-a800m`` at full width and depth served
through ``ServeEngine.generate`` (batch 8, 128-token prompts, 32 tokens;
then qwen with 2,048-token prompts and 8 tokens), bf16 prefill against
forward, ``blockwise_attention`` against a plain softmax, decode against
forward teacher-forced at fp32, and five families' smoke configs on the
card against the CPU (see its docstring).  The path builds no kernel.  It
prints one JSON line with the path's numbers, then the card's name and
power limit.  It needs a card; without one it exits nonzero.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lm_serving_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke as cs

    ctx = cs.standalone_context()
    cs.log(json.dumps({"lm_serving": cs.lm_serving_path(ctx)}))
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
