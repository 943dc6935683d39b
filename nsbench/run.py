"""Run one cell of the benchmark once, on the card, and print its result.

    python3 nsbench/run.py --workload reddit.spmm --seed 7 --seconds 10 \\
        --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``nsbench/``
and the program under ``src/``.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``compared`` last);
the last lines of standard error give each compared number beside its
limit.  Exits non-zero, printing no result, without a CUDA device (or
with fewer than the cell asks for), without the program, or where a
module of JAX or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run of a cell builds."""
    build = CHECKOUT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def _json_safe(x):
    """A JSON-safe copy: an unbounded reading prints as the largest float."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path.insert(0, str(CHECKOUT))
    sys.path.insert(0, str(CHECKOUT / "src"))
    from nsbench import harness

    bench = harness.Bench.load(CHECKOUT / "BENCHMARK.json")
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nsbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    line = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"nsbench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_json_safe(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
