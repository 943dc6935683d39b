"""Faults planted in the program under a run, to show that the check
catches them: a run with one of these in place has to come out with
``correct`` false.  Each kind (``kinds/<kind>.py``) lists its own in
``FAULTS``, a context manager for each; this file holds what they share
and the command that reads them at a cell's own size.  No cell spans
chips, so there is no exchange between chips to leave out.

    python3 nsbench/faults.py --workload ogbn-arxiv.gcn_train \\
        --seeds 1,2,3 --seconds 1 --out build/faults.json

runs the cell with each fault of its kind on each seed (on the card) and
reports the numbers its check compared.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Iterator

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@contextlib.contextmanager
def patched(target, name: str, value) -> Iterator[None]:
    """``name`` of a module, or of a module's ``globals()``, set to
    ``value`` for the block."""
    space = target if isinstance(target, dict) else vars(target)
    old = space[name]
    space[name] = value
    try:
        yield
    finally:
        space[name] = old


def one_hot_like(c):
    """A tensor of C's shape, 1 at its first entry and 0 elsewhere."""
    import torch

    e = torch.zeros_like(c)
    e.view(-1)[0] = 1.0
    return e


def planted(bench, workload: str, fault: str):
    """A context manager with ``fault`` planted in the program under
    ``workload``."""
    return bench.kind_of(workload).FAULTS[fault]()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root.parent / "src"))
    from nsbench.harness import Bench, run_cell

    bench = Bench.load(root.parent / "BENCHMARK.json", root)
    out = {"workload": args.workload, "readings": {}}
    for fault in bench.kind_of(args.workload).FAULTS:
        rows = []
        for seed in (int(s) for s in args.seeds.split(",")):
            with planted(bench, args.workload, fault):
                line = run_cell(bench, args.workload, seed, args.seconds,
                                False, "cuda")
            rows.append({"seed": seed, "correct": line["correct"],
                         "compared": {k: v["value"] for k, v
                                      in line["compared"].items()}})
        out["readings"][fault] = rows
        print(json.dumps({fault: rows}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
