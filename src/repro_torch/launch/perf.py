"""Perf hillclimb: the reference's cells, iterations, hypotheses and
overrides, run through the port's dry run.  A port of
``repro.launch.perf``.

Each iteration is one configuration of a cell, traced and probed by
``dryrun.run_cell`` on the single-pod mesh and written under
``artifacts/perf_torch``.  The hypotheses are the reference's, written
about its TPU programs; the port's records give the same cells' H100
roofline terms (``launch.step_analysis``).

    PYTHONPATH=src python -m repro_torch.launch.perf [--cell qwen-decode] [--iter N]
"""
import argparse
import json
import os
from typing import Any, Dict

import torch

from ..distributed.sharding import AxisRules
from .dryrun import run_cell

SERVE_TP_ONLY = AxisRules(batch_axes=("data",), fsdp_axes=(), tp_axis="model")
TRAIN_EP = AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                     tp_axis="model", expert_axis="model")
TRAIN_SMAP = AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                       tp_axis="model", moe_fsdp=False)
TRAIN_SP = AxisRules(batch_axes=("data",), fsdp_axes=("data",),
                     tp_axis="model", seq_axis="model")

# cell -> ordered iterations: (name, hypothesis, overrides, rules)
HILLCLIMB: Dict[str, Dict[str, Any]] = {
    # worst roofline fraction: decode dominated by per-token FSDP regathers
    "qwen-decode": {
        "arch": "qwen1.5-4b",
        "shape": "decode_32k",
        "iters": [
            ("flash-bf16-attn",
             "bf16 QK/PV matmuls with fp32 softmax halve attention bytes; "
             "predicted: memory term ~-40%, collective unchanged",
             {}, None),
            ("serve-tp-only",
             "decode all-gathers 109 GB/token of fp32 params because FSDP "
             "re-gathers weights every step; serving should keep weights "
             "TP-sharded and DP-replicated. predicted: all-gather bytes -> "
             "~0, collective term 2.18s -> <0.01s",
             {}, SERVE_TP_ONLY),
            ("serve-bf16-weights",
             "serving reads weights once per token; bf16 weights halve the "
             "param-read bytes. predicted: memory term ~-45%",
             {"param_dtype": torch.bfloat16}, SERVE_TP_ONLY),
            ("decode-hd-layout",
             "REFUTED iter 1-2: the 108 GB all-gather is the KV cache being "
             "last-resort replicated (kv=20 %% tp=16 != 0), not params. Fix: "
             "constrain cache+q to hd-TP sharding in the decode path and "
             "make cache specs hd-sharded; contraction over sharded hd "
             "costs one tiny logits psum at sq=1. predicted: all-gather "
             "1.08e11 -> <1e9, collective term 2.16s -> <0.05s",
             {"param_dtype": torch.bfloat16}, SERVE_TP_ONLY),
            ("int8-kv-cache",
             "memory term is now cache reads (13.4 GB/device bf16). int8 "
             "cache (nemotron-style) halves it. predicted: memory term "
             "0.165s -> ~0.09s, device memory fits 16GB",
             {"param_dtype": torch.bfloat16, "kv_cache_dtype": "int8"},
             SERVE_TP_ONLY),
        ],
    },
    # most collective-bound: FSDP expert-weight regathers x microbatches
    "llama4-train": {
        "arch": "llama4-scout-17b-a16e",
        "shape": "train_4k",
        "iters": [
            ("flash-bf16-attn",
             "bf16 attention matmuls; predicted: memory term -30%+ "
             "(fp32 attention internals were the largest bytes source)",
             {}, None),
            ("expert-parallel",
             "expert weights (the 100B bulk) are FSDP-gathered per layer per "
             "microbatch (~1.3GB x 48L x 8mb x fwd/bwd ~ 2.5TB). EP shards "
             "experts over the model axis: GSPMD moves tokens (all-to-all, "
             "~50MB/layer/mb) instead of weights. predicted: collective "
             "term 68.8s -> <20s",
             {}, TRAIN_EP),
            ("shard_map-fsdp-gather",
             "REFUTED iter 1: GSPMD EP cut collectives only 16% and "
             "inflated compute 2.9x (dispatch got rewritten worse). New "
             "approach: shard_map dispatch with FSDP weights all-gathered "
             "INSIDE the block in bf16 — per layer per microbatch a device "
             "gathers only its ff-shard (252MB bf16) instead of fp32 "
             "expert tensors, and the dispatch scatter stays local. "
             "predicted: collective 68.8s -> ~3s, compute back to ~3.4s, "
             "memory term drops with weight re-reads",
             {"moe_impl": "shard_map"}, None),
        ],
    },
    # most representative of the paper: MoE dispatch IS the block-sparse SpMM
    "granite-moe-train": {
        "arch": "granite-moe-3b-a800m",
        "shape": "train_4k",
        "iters": [
            ("flash-bf16-attn",
             "bf16 attention matmuls (global change); predicted: small "
             "memory-term win, compute/collective unchanged",
             {}, None),
            ("shard_map-dispatch",
             "GSPMD rewrites the global dispatch scatter into dense one-hot "
             "contractions: HLO flops ~1000x useful (useful ratio 0.01). "
             "shard_map pins dispatch per device (true local scatter) and "
             "psums one activation-sized tensor over TP — the paper's "
             "'route work to the engine that owns it'. predicted: compute "
             "term 14.6s -> <1s, collective 51.6s -> <10s",
             {"moe_impl": "shard_map"}, TRAIN_SMAP),
            ("smap-mb2",
             "with dispatch fixed, remaining collectives scale with "
             "microbatch count; halve it. predicted: collective -40%, "
             "memory x2 but <16GB",
             {"moe_impl": "shard_map", "num_microbatches": 2}, TRAIN_SMAP),
        ],
    },
}


HILLCLIMB["nemotron-train"] = {
    # bonus 4th cell: largest model, highest MFU, memory-bound, 56 GB/device
    "arch": "nemotron-4-340b",
    "shape": "train_4k",
    "iters": [
        ("seq-parallel-residual",
         "the 56.7 GB/device is dominated by per-layer residual "
         "activations (96 x ~150MB/micro at mb=16) plus optimizer state; "
         "sharding the residual stream over the TP axis between layer "
         "groups (Megatron sequence parallelism) cuts the boundary "
         "activations 16x. predicted: device memory 56.7 -> ~45 GB, "
         "memory term roughly unchanged (same bytes, different residency)",
         {}, TRAIN_SP),
    ],
}


HILLCLIMB["zamba2-train"] = {
    # bonus 5th cell: SSM-family cells are memory-bound with fp32 SSD
    "arch": "zamba2-1.2b",
    "shape": "train_4k",
    "iters": [
        ("bf16-ssd-operands",
         "the SSD chunked einsums read x/B/C in fp32; keeping them bf16 "
         "with fp32 accumulation (flash numerics; decay statistics stay "
         "fp32) halves the dominant operand traffic. predicted: memory "
         "term 13.0s -> ~9-10s, device memory 31.8 -> ~25 GB",
         {}, None),
    ],
}


def run_iteration(cell_key: str, idx: int, out_dir: str = "artifacts/perf_torch"):
    cell = HILLCLIMB[cell_key]
    name, hypothesis, overrides, rules = cell["iters"][idx]
    rec = run_cell(
        cell["arch"], cell["shape"], multi_pod=False, out_dir=out_dir,
        overrides=overrides or None, tag=f"__{idx}_{name}", probe=True,
        rules=rules,
    )
    rec["iteration"] = {"cell": cell_key, "index": idx, "name": name,
                        "hypothesis": hypothesis}
    path = os.path.join(
        out_dir, f"{cell['arch']}__{cell['shape']}__pod16x16__{idx}_{name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"[{cell_key} #{idx} {name}] dom={r['dominant']} "
              f"compute={r['compute_s']:.3f}s memory={r['memory_s']:.3f}s "
              f"collective={r['collective_s']:.3f}s "
              f"frac={r['roofline_fraction']:.3f} "
              f"mem={rec['memory']['total_per_device_gb']}GB", flush=True)
    else:
        print(f"[{cell_key} #{idx} {name}] {rec['status']}: "
              f"{rec.get('error', '')[:200]}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all",
                    choices=["all"] + list(HILLCLIMB))
    ap.add_argument("--iter", type=int, default=-1)
    ap.add_argument("--out", default="artifacts/perf_torch")
    args = ap.parse_args(argv)
    cells = list(HILLCLIMB) if args.cell == "all" else [args.cell]
    for c in cells:
        idxs = (range(len(HILLCLIMB[c]["iters"]))
                if args.iter < 0 else [args.iter])
        for i in idxs:
            run_iteration(c, i, args.out)


if __name__ == "__main__":
    main()
