"""Dry run: trace every (arch x shape) cell at full size on the production
meshes as a partitioned program on the ``meta`` device, and record each
device's memory, costs, collectives and H100 roofline terms.  A port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out artifacts/dryrun_torch

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``.  No data is
ever allocated: params, optimizer state, caches and batches are ``meta``
tensors, and no card is needed.

A cell is a DTensor program, as the reference's is XLA's partitioned
module: its args are placed by their ``NamedSharding``\\ s over a
``fake``-backend device mesh of the cell's names and sizes, and the step
runs as rank 0 of it (``specs.build_cell(..., partitioned=True)``), on
that device's shards, issuing its collectives (``"partitioned": true``).

Per cell:

1. The build proof: the cell's step traced at full depth
   (``count_step``), timed as ``t_trace_s`` (the reference's lower and
   compile times).  A train cell traces at most 2 of its microbatches
   (``traced_microbatches``), each of one device's share of a microbatch
   (rounded up to one sequence): the temp peak is reached in the second,
   once the fp32 accumulators exist, and every later microbatch repeats
   it.
2. Memory per device: ``argument_bytes`` sums the params, optimizer
   state, cache and batch by their ``NamedSharding.shard_shape``;
   ``temp_bytes`` is the trace's peak of rank 0's local storages above
   them (``"temp_bound": "device"``: that device's own peak, not a bound
   over the cell).
3. The probe-extrapolated costs (``roofline.probe_roofline``): FLOPs and
   bytes accessed of one device's local ops, and the collectives it
   issues (``collective_schedule``), for the whole step.  The roofline
   table reads the single-pod mesh's.
"""
import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, get_arch, list_archs
from ..distributed import sharding as shd
from . import step_analysis
from .mesh import make_production_mesh
from .roofline import probe_roofline
from .specs import build_cell, optimized_cell_config

TRACED_MICROBATCHES = 2


def _shard_bytes(tree: Any, shardings: Any) -> int:
    """Bytes of every tensor of ``tree`` by its sharding's block; a Python
    int (the decode length) counts as the reference's int32 scalar."""
    if isinstance(tree, dict):
        return sum(_shard_bytes(tree[k], shardings[k]) for k in tree)
    if isinstance(tree, tuple):
        return sum(_shard_bytes(t, s) for t, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        shape = shardings.shard_shape(tuple(tree.shape))
        return math.prod(shape) * tree.element_size()
    return 4


def _output_bytes(cell) -> int:
    """Per-device bytes of the step's outputs, by its out shardings."""
    meta, cfg = cell.meta, cell.cfg
    if meta["kind"] == "train":
        return _shard_bytes(cell.args[:2], cell.in_shardings[:2]) + 3 * 4
    b = meta["global_batch"]
    logits = ((b, meta["seq_len"], cfg.padded_vocab) if cfg.encoder_only
              else (b, cfg.padded_vocab))
    out = _shard_bytes(torch.empty(logits, device="meta"),
                       cell.out_shardings if cfg.encoder_only
                       else cell.out_shardings[0])
    if not cfg.encoder_only:
        out += _shard_bytes(cell.args[2], cell.in_shardings[2])
    return out


def trace_cell(arch, shape_name: str, cell, overrides, rules
               ) -> Dict[str, Any]:
    """The full-depth trace of the partitioned cell (see the module
    docstring): one device's counts, temp peak and collectives, and the
    trace's seconds."""
    meta, mesh = cell.meta, cell.mesh
    sizes = dict(mesh.shape)
    n_b = shd._axes_size(
        shd._batch_axes_fit(cell.rules, meta["global_batch"], sizes), sizes)
    ov = dict(overrides or {})
    traced = {"global_batch": meta["global_batch"]}
    if meta["kind"] == "train":
        m = meta["microbatches"]
        micro = step_analysis.device_microbatch(meta["global_batch"], m, n_b)
        tm = min(m, TRACED_MICROBATCHES)
        ov.update(num_microbatches=tm, global_batch=micro * n_b * tm)
        traced.update(global_batch=micro * n_b * tm, microbatches=tm)
    tcell = build_cell(arch, shape_name, mesh, overrides=ov,
                       analysis_mode=False, rules=rules, partitioned=True)
    t0 = time.perf_counter()
    count = step_analysis.count_step(tcell.fn, *tcell.args)
    traced.update(flops=count.flops, bytes=count.bytes_accessed,
                  temp_peak_bytes=count.temp_peak_bytes,
                  collectives=count.collectives,
                  t_trace_s=round(time.perf_counter() - t0, 2))
    return traced


def run_cell(
    arch_name: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: str,
    overrides: Optional[Dict[str, Any]] = None,
    tag: str = "",
    probe: bool = True,
    rules=None,
    opt: bool = False,
    mesh=None,
) -> Dict[str, Any]:
    """One cell on the production mesh (``multi_pod`` picks which), or on
    ``mesh`` when given (named by its shape, e.g. ``mesh1x1``)."""
    arch = get_arch(arch_name)
    ok, reason = arch.applicable(shape_name)
    if mesh is None:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        mesh_name = "mesh" + "x".join(str(s) for s in mesh.axis_sizes)
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "status": "skip", "reason": reason,
    }
    name = f"{arch_name}__{shape_name}__{mesh_name}{tag}"
    if not ok:
        _write(out_dir, name, rec)
        return rec

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    if opt:
        opt_rules, opt_ov = optimized_cell_config(arch, shape_name, mesh)
        rules = rules or opt_rules
        overrides = {**opt_ov, **(overrides or {})}
        rec["optimized"] = True
    try:
        # 1) the full-depth trace: THE build proof + the temp peak
        cell = build_cell(arch, shape_name, mesh, overrides=overrides,
                          analysis_mode=False, rules=rules)
        traced = trace_cell(arch, shape_name, cell, overrides, cell.rules)
        arg_bytes = _shard_bytes(cell.args, cell.in_shardings)
        temp = traced["temp_peak_bytes"]
        total = arg_bytes + temp
        rec.update({
            "status": "ok",
            "meta": cell.meta,
            "partitioned": True,
            "t_trace_s": traced["t_trace_s"],
            "traced": traced,
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": _output_bytes(cell),
                "temp_bytes": temp,
                "temp_bound": "device",
                "total_per_device_gb": round(total / 2**30, 3),
                "fits_80gb_hbm": bool(total < step_analysis.HBM_BYTES),
            },
            # the traced microbatches' until the probes give the step's
            "collective_schedule": traced["collectives"],
        })
        if cell.meta["kind"] == "train":
            rec["traced_microbatches"] = traced["microbatches"]

        # 2) probe-extrapolated cost metrics (single-pod roofline table only)
        if probe:
            pr = probe_roofline(
                arch, shape_name, mesh, overrides=overrides or None,
                rules=rules,
            )
            n_chips = math.prod(mesh.axis_sizes)
            rec["collective_schedule"] = {
                k: int(round(pr["est"][f"coll_{k}"]))
                for k in step_analysis.COLLECTIVES + ("count",)}
            # MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N·D for inference
            flops_per_param_token = 6.0 if cell.meta["kind"] == "train" else 2.0
            model_flops = (flops_per_param_token
                           * cell.meta["active_params"] * _tokens(cell.meta))
            traced_total = pr["est"]["flops"] * n_chips
            rec.update({
                "cost": {
                    "flops_per_device": pr["est"]["flops"],
                    "bytes_per_device": pr["est"]["bytes"],
                },
                "collectives": {
                    k.replace("coll_", ""): v
                    for k, v in pr["est"].items() if k.startswith("coll_")
                },
                "roofline": pr["roofline"],
                "probes": pr["probes"],
                "model_flops_total": model_flops,
                "traced_flops_total": traced_total,
                "useful_flops_ratio": (
                    model_flops / traced_total if traced_total else 0.0
                ),
            })
    except Exception as e:  # record failures — they are bugs to fix
        rec.update({
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        })
    _write(out_dir, name, rec)
    return rec


def _tokens(meta: Dict[str, Any]) -> float:
    if meta["kind"] == "train":
        return meta["seq_len"] * meta["global_batch"]
    if meta["kind"] == "prefill":
        return meta["seq_len"] * meta["global_batch"]
    return meta["global_batch"]  # decode: one token per sequence


def _write(out_dir: str, name: str, rec: Dict[str, Any]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip probe-based cost extrapolation")
    ap.add_argument("--opt", action="store_true",
                    help="use the winning §Perf configuration per cell")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_err = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                # the probes give every cell's step collectives; the
                # roofline table reads the single-pod mesh's
                rec = run_cell(a, s, mp, args.out,
                               probe=not args.no_probe, opt=args.opt)
                tag = rec["status"]
                n_ok += tag == "ok"
                n_skip += tag == "skip"
                n_err += tag == "error"
                extra = ""
                if tag == "ok":
                    dom = rec.get("roofline", {}).get("dominant", "-")
                    extra = (f" dom={dom}"
                             f" mem={rec['memory']['total_per_device_gb']}GB"
                             f" trace={rec['t_trace_s']}s")
                elif tag == "error":
                    extra = " " + rec["error"][:120]
                elif tag == "skip":
                    extra = " " + rec["reason"]
                print(f"[{tag:5s}] {a} {s} "
                      f"{'multi' if mp else 'single'}{extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skip, {n_err} error", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
