"""Markdown tables of the dry run's records: the dry-run table, the
single-pod roofline table and a summary.  A port of
``repro.launch.report`` with the H100 in place of the TPU: "fits 80 GB"
for "fits 16GB" (decided by each device's own peak of the partitioned
program: argument plus temp bytes), the trace's seconds for the
compile's, the collectives the partitioned program issues (counted) for
those parsed from the scanned HLO, and ``mfu_at_bound`` at the H100's
dense bf16 peak.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun_torch]

Prints markdown to stdout.  The numbers are computed on the CPU, not
measured on a card.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, List

from .step_analysis import PEAK_FLOPS_BF16


def load(dirname: str) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | per-device mem | fits 80 GB | trace | collectives (counted) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skip":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP | — | — | — | {r['reason']} |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** | — | — | — | {r.get('error', '')[:60]} |")
            continue
        m = r["memory"]
        c = r.get("collective_schedule", {})
        csum = ", ".join(f"{k}:{v}" for k, v in c.items()
                         if k != "count" and v) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{m['total_per_device_gb']} GB | "
            f"{'yes' if m['fits_80gb_hbm'] else 'NO'} | "
            f"{r['t_trace_s']}s | count={c.get('count', 0)} ({csum[:80]}) |")
    return "\n".join(lines)


PEAK = PEAK_FLOPS_BF16


def _chips(rec: Dict) -> int:
    """The device count of the record's mesh ("16x16" in its meta, or the
    name "pod2x16x16" / "mesh1x1")."""
    shape = rec.get("meta", {}).get("mesh") or rec.get("mesh", "")
    return math.prod(int(part) for part in
                     shape.replace("pod", "").replace("mesh", "").split("x"))


def mfu_at_bound(rec: Dict) -> float:
    """Useful-model-FLOPs time / roofline bound — the honest perf score.
    (roofline_fraction = counted-compute/bound rewards *inflated* compute.)"""
    useful_s = rec.get("model_flops_total", 0) / _chips(rec) / PEAK
    bound = rec.get("roofline", {}).get("bound_s", 0)
    return useful_s / bound if bound else 0.0


def roofline_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MFU@bound | MODEL/traced flops | mem GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    rows = [r for r in recs
            if r.get("mesh") == "pod16x16" and r.get("status") == "ok"
            and "roofline" in r]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4f} | "
            f"{rl['memory_s']:.4f} | {rl['collective_s']:.4f} | "
            f"**{rl['dominant']}** | {mfu_at_bound(r):.3f} | "
            f"{r.get('useful_flops_ratio', 0):.2f} | "
            f"{r['memory']['total_per_device_gb']} |")
    return "\n".join(lines)


def summary(recs: List[Dict]) -> str:
    ok = sum(1 for r in recs if r["status"] == "ok")
    skip = sum(1 for r in recs if r["status"] == "skip")
    err = sum(1 for r in recs if r["status"] == "error")
    fits = sum(1 for r in recs if r["status"] == "ok"
               and r["memory"]["fits_80gb_hbm"])
    return (f"**{ok} cells traced OK** ({fits} fit 80 GB HBM/device at "
            f"their device's own peak), {skip} spec'd skips, {err} errors.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("### Dry-run summary\n")
    print(summary(recs) + "\n")
    print(dryrun_table(recs) + "\n")
    print("### Roofline (single-pod 16x16, per device, H100 peaks)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
