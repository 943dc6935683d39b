"""Dynamic serving walkthrough: a mutation stream over a live SpmmService.

Drives ``SpmmService.update_matrix`` with a ``data.graphs.mutate`` edge
stream: weight refreshes ride the value fast path, edge inserts and
deletes accumulate in the delta sidecar until the cost model folds them
in, and the persistent plan registry warm-starts a "restarted" service
without running ``prepare`` again.

    PYTHONPATH=src python -m repro_torch.examples.dynamic_serving \\
        [--device cpu] [--dataset ogbn-arxiv] [--steps 5]

Runs on the card by default; ``--device cpu`` runs the plain versions.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.plan_ir import SpmmConfig
from repro_torch.core.spmm import prepare_call_count
from repro_torch.data import graphs
from repro_torch.dynamic import PlanRegistry
from repro_torch.exec import fused_trace_count
from repro_torch.serve import SpmmService


def main(device: str = "cuda", dataset: str = "ogbn-arxiv",
         steps: int = 5) -> dict:
    spec = graphs.PAPER_DATASETS[dataset]
    rows, cols, vals = graphs.generate(spec)
    shape = (spec.m, spec.k)
    rng = np.random.RandomState(0)
    config = SpmmConfig(impl="torch" if device == "cpu" else "cuda")

    with tempfile.TemporaryDirectory() as root:
        registry = PlanRegistry(root)
        svc = SpmmService(config, max_batch=4, registry=registry)
        svc.register("graph", rows, cols, vals, shape)  # prepares, persists
        print(f"registered: nnz={rows.size}, registry={registry.names()}")

        # serve a panel after each mutation batch
        b = torch.from_numpy(rng.randn(shape[1], 64).astype(np.float32))
        builds0 = fused_trace_count()
        stream = graphs.mutate(rows, cols, vals, shape, steps=steps,
                               insert_frac=0.01, delete_frac=0.01,
                               update_frac=0.05, seed=1)
        for step, delta in enumerate(stream):
            stats = svc.update_matrix("graph", delta)
            ticket = svc.submit("graph", b)
            svc.flush(name="graph")
            out = svc.fetch(ticket)
            dplan = svc.plan("graph")
            print(f"step {step}: +{delta.ins_rows.size} edges "
                  f"-{delta.del_rows.size} edges "
                  f"~{delta.upd_rows.size} weights | "
                  f"fast-path={stats['fast_path']} "
                  f"sidecar={dplan.delta_nnz} "
                  f"compacted={stats['compacted']} | "
                  f"C[0,0]={float(out[0, 0]):+.3f}")
        builds = fused_trace_count() - builds0
        print(f"executor builds over {steps} mutation steps: {builds} "
              "(sidecar capacity doublings only: weight refreshes build "
              "nothing)")
        svc.close()

        # "restart": a fresh service warm-starts from disk with no prepare
        svc2 = SpmmService(config, max_batch=4, registry=registry)
        prepares = prepare_call_count()
        svc2.warm_start("graph")
        ticket = svc2.submit("graph", b)
        svc2.flush()
        out2 = svc2.fetch(ticket)
        restored_prepares = prepare_call_count() - prepares
        print(f"warm start: prepare() calls during restore: "
              f"{restored_prepares}, C[0,0]={float(out2[0, 0]):+.3f} "
              "(the mutated matrix, served at once)")
        svc2.close()
    return {"last": out, "restored": out2, "builds": builds,
            "restored_prepares": restored_prepares}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dataset", default="ogbn-arxiv",
                    choices=sorted(graphs.PAPER_DATASETS))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    main(args.device, args.dataset, args.steps)
