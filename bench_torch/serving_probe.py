#!/usr/bin/env python3
"""``chip_smoke.py``'s serving path alone, on one NVIDIA GPU.

    python3 bench_torch/serving_probe.py

Run from the root of a checkout.  It builds the kernels and the GCN
path's graph at ogbn-arxiv size (169,343 nodes, 2,481,327 nonzeros), then
runs ``chip_smoke.serving_path``: ``SpmmService`` over a dynamic plan of
that graph with request rounds that run every bucket of ``max_batch`` 8,
the reference example's mutation stream through ``update_matrix``, B2 and
B3 on the sidecar with and without its padding, a fold forced through a
tuned threshold, quarantine, a warm start from the registry and a
background tune read back with no microbenchmark (see its docstring).  It
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
        print("serving_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build_all()
    ctx = cs.standalone_context()
    graph = cs.arxiv_gcn_graph()
    cs.log(f"graph: {graph[0].size} nonzeros in {graph[-1]:.1f} s")
    cs.log(json.dumps({"serving": cs.serving_path(ctx, graph)}))
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
