#!/usr/bin/env python3
"""The measurement behind spspmm's numeric phase (``exec.pipeline.
_spspmm_body``) on one NVIDIA GPU, and ``chip_smoke.py``'s two-hop and
health phases alone.

    python3 bench_torch/two_hop_probe.py

Run from the root of a checkout.  It builds the kernels, then:

- runs ``chip_smoke.two_hop_path`` (``A @ A`` through the facade on the
  directed ogbn-arxiv-size graph, its checks and times) and
  ``chip_smoke.health_phase`` (the health gate and ``deadline=``), as
  ``chip_smoke.py`` runs them after its other phases;
- sums the product's 10,451,327 fp32 terms into its 8,613,042 cells with
  ``torch.segment_reduce`` on the card in the two forms PyTorch offers: a
  1-D operand and an ``(n, 1)`` one.  It counts the cells whose bits
  differ from the CPU's sequential sum (the reference's order) and times
  each form with CUDA events.

It prints one JSON line per part, then the card's name and power limit.
It needs a card; without one it exits nonzero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("two_hop_probe.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    import repro_torch.sparse as sp
    from repro_torch.exec import api
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
        err = (got - want).abs().max().item()
        cs.require(err <= cs.TOL * max(1.0, want.abs().max().item()), err)
        return err

    def timed_ms(fn, reps=20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    ctx = types.SimpleNamespace(
        sp=sp, dev=dev, log=log, require=cs.require, drive=drive,
        err_bound=err_bound, timed_ms=timed_ms, tol=cs.TOL)
    a, p, _, two_hop = cs.two_hop_path(ctx)
    log(json.dumps({"two_hop": two_hop}))

    # the two forms of segment_reduce on the product's terms
    maps = a.plan.update_maps
    t0 = time.perf_counter()
    ae, be, lengths, _ = api.spspmm_symbolic(maps, maps, a.shape[1],
                                             a.plan.config.bm)
    t_symbolic = time.perf_counter() - t0
    va = torch.as_tensor(maps.host_values(), dtype=torch.float32)
    prod = (torch.index_select(va, 0, torch.from_numpy(ae))
            * torch.index_select(va, 0, torch.from_numpy(be)))
    lens = torch.from_numpy(lengths)
    cpu = torch.segment_reduce(prod[:, None], "sum", lengths=lens, axis=0,
                               unsafe=True)[:, 0]
    prod_d, lens_d = prod.to(dev), lens.to(dev)
    forms = {
        "1-D": lambda: torch.segment_reduce(
            prod_d, "sum", lengths=lens_d, axis=0, unsafe=True),
        "(n, 1)": lambda: torch.segment_reduce(
            prod_d[:, None], "sum", lengths=lens_d, axis=0,
            unsafe=True)[:, 0],
    }
    for name, form in forms.items():
        got = form().cpu()
        log(json.dumps({"segment_reduce": name, "cells": cpu.numel(),
                        "terms": prod.numel(),
                        "longest_cell": int(lengths.max()),
                        "cells_with_other_bits": int(
                            (got.view(torch.int32)
                             != cpu.view(torch.int32)).sum()),
                        "ms": timed_ms(form),
                        "symbolic_s": t_symbolic}))
    log(json.dumps({"health": cs.health_phase(ctx, a, p)}))
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
