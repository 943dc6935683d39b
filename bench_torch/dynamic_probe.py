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
import types
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
    import repro_torch.sparse as sp
    from repro_torch.core import cost_model
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    _build.build_all()

    def log(*args):
        print(*args, flush=True)

    def drive(path):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = path()
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    def err_bound(got, want):
        torch.cuda.synchronize()
        cs.require(got.shape == want.shape, (got.shape, want.shape))
        cs.require(bool(torch.isfinite(got).all()), "non-finite output")
        err = (got - want).abs().max().item()
        cs.require(err <= cs.TOL * max(1.0, want.abs().max().item()), err)
        return err

    def timed_ms(fn, budget_ms=300.0, max_reps=200):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        reps = int(min(max_reps, max(2, budget_ms // max(
            start.elapsed_time(end), 1e-3))))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def measure(label, kern, plain, library, nbytes, flops):
        err = err_bound(kern(), plain())
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        lib_ms = timed_ms(library)
        t_bytes = nbytes / cost_model.H100_HBM_BYTES_PER_S * 1e3
        t_ops = flops / cost_model.H100_FP32_FLOPS_PER_S * 1e3
        bms = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {label}: {ms:.3f} ms (plain {plain_ms:.3f} ms, library "
            f"{lib_ms:.3f} ms, bound {bms:.4f} ms by {by}); max |kernel - "
            f"plain| {err:.3e}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}

    def csr_of(r, c, v, shape):
        idx = torch.stack([torch.as_tensor(r), torch.as_tensor(c)]).to(dev)
        return torch.sparse_coo_tensor(
            idx, torch.as_tensor(v, dtype=torch.float32).to(dev), shape,
        ).coalesce().to_sparse_csr()

    ctx = types.SimpleNamespace(
        sp=sp, dev=dev, log=log, require=cs.require, drive=drive,
        err_bound=err_bound, timed_ms=timed_ms, measure=measure,
        csr_of=csr_of)
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
