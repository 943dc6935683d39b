#!/usr/bin/env python3
"""``chip_smoke.py``'s dynamic path alone, on one NVIDIA GPU.

    python3 bench_torch/dynamic_probe.py

Run from the root of a checkout.  It builds the kernels and the GCN
path's graph at ogbn-arxiv size (169,343 nodes, 2,481,327 nonzeros), then
runs ``chip_smoke.dynamic_path``: the reference example's mutation stream
through ``DynamicPlan`` on both sidecar tiers, B2 and B3 on the sidecar
against their plain versions and timed beside their bounds, B's gradient,
the registry round trip, the armed ``fused+delta`` build, the fold and
bench_dynamic's three rows (see its docstring).  It prints one JSON line
with the path's numbers, then the card's name and power limit.  It needs
a card; without one it exits nonzero.
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
        print("dynamic_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build_all()
    ctx = cs.standalone_context()
    log = cs.log
    graph = cs.arxiv_gcn_graph()
    log(f"graph: {graph[0].size} nonzeros in {graph[-1]:.1f} s")
    log(json.dumps({"dynamic": cs.dynamic_path(ctx, graph)}))
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
