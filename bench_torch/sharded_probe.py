#!/usr/bin/env python3
"""``chip_smoke.py``'s sharded path alone, on one NVIDIA GPU (or more).

    python3 bench_torch/sharded_probe.py

Run from the root of a checkout.  It builds the kernels, the Reddit-scale
graph of the main path (232,965 nodes, 70,525,725 nonzeros) and the GCN
path's graph at ogbn-arxiv size, then runs ``chip_smoke.sharded_path``: a
4-way mesh over the visible cards (one card repeated where there are
fewer), the Reddit graph sharded by rows (``prepare_sharded`` seconds,
balance, peak memory, ``spmm`` and a batch-2 ``bspmm`` by CUDA events,
launches per call, errors against ``torch.sparse.mm``), then at
ogbn-arxiv size an rhs-sharded ``spmm``, the sharded SDDMM against
``torch.sparse.sampled_addmm``, a sharded ``DynamicPlan`` over the
reference example's stream, a registry warm start re-sharded onto the
mesh and ``SpmmService.register_sharded`` (see its docstring).  It prints
one JSON line with the path's numbers, then the card's name and power
limit.  It needs a card; without one it exits nonzero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch.data.graphs import GraphSpec, generate
    from repro_torch.kernels import _build

    _build.build_all()
    ctx = cs.standalone_context()
    spec = GraphSpec(**cs.REDDIT)
    t0 = time.perf_counter()
    rows, cols, vals = generate(spec)
    cs.log(f"reddit-scale graph: {rows.size} nonzeros in "
           f"{time.perf_counter() - t0:.1f} s")
    graph = cs.arxiv_gcn_graph()
    cs.log(f"graph: {graph[0].size} nonzeros in {graph[-1]:.1f} s")
    out = cs.sharded_path(ctx, (rows, cols, vals, (spec.m, spec.k)), graph)
    cs.log(json.dumps({"sharded": out}, default=str))
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
