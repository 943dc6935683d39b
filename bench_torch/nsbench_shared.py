#!/usr/bin/env python3
"""``nsbench/faults.py``, ``nsbench/control.py`` or the program's own
check readings, with each configuration's graph, its plan and the plain
reference's operators built once per process.

    python3 bench_torch/nsbench_shared.py faults --workload reddit.gcn_train \\
        --seeds 1,2,3 --out build/faults.reddit.gcn_train.json
    python3 bench_torch/nsbench_shared.py control --workload ... --seeds ...
    python3 bench_torch/nsbench_shared.py sound --workload ... --seeds ... \\
        [--seconds 0.5] [--out ...]

Several commands run in one process when joined by ``+``, sharing what
was built: ``sound --workload w --seeds 1,2 + control --workload w
--seeds 3,4``.  ``sound`` runs the cell with nothing planted and prints
each seed's ``correct`` and the numbers its check compared, as
``faults.py`` does for a fault.

Run from the root of a checkout, on the card.  The arguments after a
command's name are the command's own.  The readings are the command's:
a configuration whose values it fixes (``"values": "gcn_normalised"``)
has one graph for every seed, and no run changes a plan (a value update
makes a new one; what plans share, ``plan.derived``, depends on the
structure alone); the reference's operators depend on the graph alone.
Where the values come from the seed the graph is built for each seed.
Only the set-up's time changes, which none of the commands reads: at
Reddit scale a plan takes about a minute to build, two with the
transpose plan of a training cell.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sound(argv) -> int:
    """The cell run on each seed with nothing planted: one JSON line per
    seed with ``correct`` and the compared numbers."""
    from nsbench.harness import Bench, run_cell

    ap = argparse.ArgumentParser(prog="sound")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = Bench.load(ROOT / "BENCHMARK.json", ROOT / "nsbench")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run_cell(bench, args.workload, seed, args.seconds, False,
                        "cuda")
        rows.append({"seed": seed, "correct": line["correct"],
                     "compared": {k: v["value"] for k, v
                                  in line["compared"].items()}})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "readings": rows}, indent=1))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    runs, cur = [], []
    for word in argv + ["+"]:
        if word == "+":
            runs.append(cur)
            cur = []
        else:
            cur.append(word)
    if not all(r and r[0] in ("faults", "control", "sound") for r in runs):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import repro_torch.sparse as sp
    from nsbench import control, drive, faults, reference

    build_graph, from_coo = drive.build_graph, sp.from_coo
    coo_operator = reference.CooOperator
    graphs, plans, operators = {}, {}, {}

    def shared_graph(bench, cfg, seed, device):
        key = (cfg["name"], str(device),
               None if cfg["values"] == "gcn_normalised" else seed)
        if key not in graphs:
            graphs[key] = build_graph(bench, cfg, seed, device)
        return graphs[key]

    def shared_plan(rows, cols, vals, shape, **kw):
        key = (id(rows), id(vals), str(kw.get("device")))
        if key not in plans:
            plans[key] = (rows, vals, from_coo(rows, cols, vals, shape, **kw))
        return plans[key][2]

    class SharedOperator(coo_operator):
        """The reference's operator, one per shared graph, with its
        transpose kept."""

        def __new__(cls, rows, cols, vals, shape, device="cpu"):
            key = (id(rows), id(cols), id(vals), str(device))
            if key not in operators:
                op = object.__new__(cls)
                coo_operator.__init__(op, rows, cols, vals, shape, device)
                operators[key] = (rows, cols, vals, op)
            return operators[key][3]

        def __init__(self, *args, **kw):
            pass

        def transpose(self):
            if not hasattr(self, "_transposed"):
                self._transposed = coo_operator(
                    self.cols.cpu().numpy(),
                    np.repeat(np.arange(self.shape[0]), self.deg),
                    self.vals32.cpu().numpy(),
                    (self.shape[1], self.shape[0]), self.device)
            return self._transposed

    drive.build_graph, sp.from_coo = shared_graph, shared_plan
    reference.CooOperator = SharedOperator
    commands = {"faults": faults.main, "control": control.main,
                "sound": sound}
    rc = 0
    for run in runs:
        rc = commands[run[0]](run[1:]) or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
