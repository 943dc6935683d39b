#!/usr/bin/env python3
"""The paths beside the benchmark's SpMM that run a plan's split, timed on
one NVIDIA GPU: the SDDMM and the graph-attention forward over a plan, a
rows-sharded plan and a ``DynamicPlan``.

    python3 bench_torch/attention_split.py [--src SRC] [--skip-reddit]
        [--out build/attention_split.json]

Run from the root of a checkout.  ``--src`` names the ``src`` directory
whose ``repro_torch`` is timed (default: this checkout's), so that two
checkouts are compared by running it twice, alternating, in one call.
The graphs are the benchmark's ogbn-arxiv and Reddit configurations
(``nsbench/configs``, generated by ``nsbench/generators``), planned by
``sparse.from_coo`` with the default split.  On each:

- ``sddmm``: ``sparse.sddmm(A, Q, K^T)`` at the attention path's widths
  (``D_IN`` = 602 input features, one head of ``D_HEAD`` = 256), by CUDA
  events, held against the row-wise dot products of Q and K;
- ``attention``: one ``SparseGraphAttention`` forward: the synchronised
  wall ms (``with_values`` included) and each kernel's device ms under
  ``torch.profiler``.

On ogbn-arxiv only: ``spmm`` on a 4-way rows-sharded plan (the card
repeated) and on a ``DynamicPlan`` after 1,000 inserts, both by CUDA
events and held against ``torch.sparse.mm``.  Prints one JSON line per
measurement, then the card's name and power limit; exits nonzero without
a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D_IN = 602
D_HEAD = 256
N = 256
TOL = 1e-4
REPS = 5


def timed_ms(fn, budget_ms=300.0):
    """Mean ms a call by CUDA events over back-to-back calls filling about
    ``budget_ms`` after a warm-up (at least 5 calls)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(max(5, budget_ms // max(start.elapsed_time(end), 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(got, want):
    """max |got - want|, raising above TOL * max(1, max|want|)."""
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not err <= TOL * scale:
        raise RuntimeError(f"max |diff| {err} > {TOL} * {scale}")
    return err


def kernel_ms(fn, reps=REPS):
    """Each kernel's device ms a call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and not e.key.startswith(("repro_torch.", "aten::",
                                           "Activity")):
            out[e.key[:80]] = t / reps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def plan_stats(plan):
    st = plan.stats_dict
    return {k: st.get(k) for k in ("alpha", "num_windows", "num_steps",
                                   "core_nnz", "fringe_nnz",
                                   "windows_to_fringe", "fringe_tier")}


def attention_record(name, rows, cols, vals, shape, dev, gen):
    import numpy as np
    import torch

    from repro_torch import sparse as sp
    from repro_torch.models import SparseGraphAttention

    t0 = time.perf_counter()
    a = sp.from_coo(rows, cols, vals, shape, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    x = torch.randn((shape[0], D_IN), generator=gen, device=dev)
    layer = SparseGraphAttention.init(a, D_IN, D_HEAD, generator=gen)
    q, k = x @ layer.wq, x @ layer.wk
    kt = k.t().contiguous()
    got = sp.sddmm(a, q, kt)
    r = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
    c = torch.from_numpy(np.asarray(cols, np.int64)).to(dev)
    step = 1 << 21
    want = torch.cat([(q[r[i:i + step]] * k[c[i:i + step]]).sum(1)
                      for i in range(0, r.numel(), step)])
    err = check(got, want)
    del got, want, r, c
    sddmm_ms = timed_ms(lambda: sp.sddmm(a, q, kt))
    sddmm_kernels = kernel_ms(lambda: sp.sddmm(a, q, kt))
    layer(x)
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layer(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    att_kernels = kernel_ms(lambda: layer(x), reps=3)
    return {"phase": "attention", "graph": name, "prepare_s": prepare_s,
            "plan": plan_stats(a.plan), "sddmm_ms": sddmm_ms,
            "sddmm_device_ms": sum(sddmm_kernels.values()),
            "sddmm_kernels_ms": sddmm_kernels, "sddmm_err": err,
            "forward_wall_ms": sorted(walls)[len(walls) // 2],
            "forward_device_ms": sum(att_kernels.values()),
            "forward_kernels_ms": att_kernels}


def arxiv_paths(rows, cols, vals, shape, dev, gen):
    """``spmm`` on a 4-way rows-sharded plan and on a DynamicPlan."""
    import numpy as np
    import torch

    from repro_torch.core.plan_ir import SpmmConfig
    from repro_torch.core.spmm import prepare, prepare_sharded
    from repro_torch.distributed import make_spmm_mesh
    from repro_torch.dynamic import DynamicPlan, GraphDelta
    from repro_torch.exec import api

    b = torch.randn((shape[1], N), generator=gen, device=dev)

    def csr(r, c, v):
        return torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([r, c])).to(dev),
            torch.from_numpy(np.asarray(v, np.float32)).to(dev),
            shape).coalesce().to_sparse_csr()

    out = []
    t0 = time.perf_counter()
    s = prepare_sharded(rows, cols, vals, shape,
                        make_spmm_mesh(devices=[dev] * 4),
                        SpmmConfig(impl="cuda"), shard_axis="rows")
    prepare_s = time.perf_counter() - t0
    err = check(api.execute_sharded(s, b), torch.sparse.mm(
        csr(rows, cols, vals), b))
    out.append({"phase": "sharded", "graph": "ogbn-arxiv", "shards": 4,
                "prepare_s": prepare_s, "core": bool(s.sig[12]),
                "spmm_ms": timed_ms(lambda: api.execute_sharded(s, b)),
                "err": err})
    rng = np.random.RandomState(0)
    key = rng.randint(0, shape[0] * shape[1], 4000, dtype=np.int64)
    key = np.unique(key[~np.isin(key, rows * shape[1] + cols)])[:1000]
    dv = rng.randn(key.size).astype(np.float32)
    dp = DynamicPlan(prepare(rows, cols, vals, shape,
                             SpmmConfig(impl="cuda"), device=dev),
                     auto_compact=False)
    dp.update(GraphDelta.inserts(key // shape[1], key % shape[1], dv))
    err = check(dp.execute(b), torch.sparse.mm(csr(
        np.concatenate([rows, key // shape[1]]),
        np.concatenate([cols, key % shape[1]]),
        np.concatenate([vals, dv])), b))
    out.append({"phase": "dynamic", "graph": "ogbn-arxiv", "inserts": 1000,
                "plan": plan_stats(dp.plan),
                "spmm_ms": timed_ms(lambda: dp.execute(b)), "err": err})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the src directory whose repro_torch is timed")
    parser.add_argument("--skip-reddit", action="store_true",
                        help="leave out the Reddit graph")
    parser.add_argument("--out", default=None,
                        help="also write the records to this JSON file")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("attention_split.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from nsbench.generators import chung_lu, sbm

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []

    def emit(rec):
        rec["src"] = args.src
        records.append(rec)
        print(json.dumps(rec), flush=True)

    graphs = [("ogbn-arxiv", sbm)]
    if not args.skip_reddit:
        graphs.append(("reddit", chung_lu))
    for name, module in graphs:
        cfg = json.loads((ROOT / "nsbench" / "configs" /
                          f"{name}.json").read_text())["graph"]
        rows, cols, vals, shape, _ = module.build(cfg, dev)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        if vals is None:
            vals = np.random.RandomState(0).randn(rows.size).astype(
                np.float32)
        emit(attention_record(name, rows, cols, vals, shape, dev, gen))
        if name == "ogbn-arxiv":
            for rec in arxiv_paths(rows, cols, vals, shape, dev, gen):
                emit(rec)
        del rows, cols, vals
        torch.cuda.empty_cache()

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi, "records": records}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
