#!/usr/bin/env python3
"""The wall time of the LM train step and decode token, for comparing two
checkouts.

    python3 bench_torch/train_step_wall.py [--src DIR] [--smoke]
        [--device cpu] [--steps 7]
    python3 bench_torch/train_step_wall.py --parent-src DIR [--smoke]
        [--device cpu] [--rounds 12] [--decode-rounds 6] [--profile N]
        [--shared-gc]

The first form runs ``train_loop.make_train_step`` on qwen1.5-4b (full
size on the card, or ``--smoke`` at fp32 compute) with 2 microbatches of
a batch of 8 x 128 (the smoke: 2 x 16), from params drawn from seed 0,
``--steps`` times, each step timed on the host clock between two
synchronisations.  ``--src`` names another checkout's ``src`` to import
the port from (a parent commit unpacked with ``git archive``).  Prints
one JSON line: the source, the device, each step's wall ms and the time
Python's cyclic garbage collector took in it, their median over all but
the first step and their mean over all but the first (a full collection
comes every few steps, so the mean carries its share); on a card also
its name and power limit.

The second form holds this checkout's port against the one under
``--parent-src DIR`` in one process: the parent's package is loaded
under another name, both step on the same params and moments, and the
two alternate call by call (parent first in even rounds, second in odd
ones), so both see the same host, card and allocator.  Before each timed
call the collector runs untimed, so that each call pays for its own
allocations only: in one shared heap a full collection would otherwise
fall on whichever side happens to cross its threshold (``--shared-gc``
leaves the collector alone, to show that).  After one
warm-up call each it times ``--rounds`` pairs of train steps, then, for
qwen1.5-4b and granite-moe-3b-a800m at full size (``--smoke``: their
smoke configs), serving's decode token (``ServeEngine.decode_fn``,
batch 8 after a 128-token prefill, the serving phase's shape):
``--decode-rounds`` pairs of 8 tokens each.  Prints one JSON line per
measurement: each side's wall ms per call, the medians, each pair's
ratio (this checkout over the parent), how many pairs this checkout was
slower in, each side's median host CPU time (the thread's CPU time
while it issues the call, before the closing synchronisation), and,
summed over each side's timed calls, the collector's time and
collections by generation and the caching allocator's device
allocations, frees and retries.  ``--profile N`` adds, after the train
pairs, one ``cProfile``\\ d step of each side: its N functions of most
own time.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = "repro_torch_parent"
_GC = {"ms": 0.0, "t0": 0.0}


def _gc_timer(phase: str, info: dict) -> None:
    """A ``gc.callbacks`` hook summing the collector's time."""
    if phase == "start":
        _GC["t0"] = time.perf_counter()
    else:
        _GC["ms"] += (time.perf_counter() - _GC["t0"]) * 1e3


def _load_parent(src: Path):
    """The port under ``src`` imported as ``repro_torch_parent`` (its
    imports are relative, so they resolve inside it)."""
    pkg = src / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        PARENT, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = mod
    spec.loader.exec_module(mod)
    return mod


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _card(dev) -> dict:
    if dev.type != "cuda":
        return {}
    return {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}


def _counts(dev) -> dict:
    """The collector's collections by generation and the caching
    allocator's device allocations, frees and retries after a failed
    allocation (each frees the cache and synchronises; none off the
    card)."""
    import torch

    out = {f"gc_gen{i}": g["collections"]
           for i, g in enumerate(gc.get_stats())}
    if dev.type == "cuda":
        st = torch.cuda.memory_stats(dev)
        out.update({k: st.get(k, 0) for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries")})
    return out


def _timed(fn, dev, counts: dict):
    """(wall ms, host ms) of ``fn()``: the wall time between
    synchronisations, and the CPU time this thread spent issuing it (up
    to the closing synchronisation, whose wait spins).  The collector's
    time and :func:`_counts` over the call are added to ``counts``."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sync()
    c0 = _counts(dev)
    _GC["ms"] = 0.0
    t0, h0 = time.perf_counter(), time.thread_time()
    fn()
    h1 = time.thread_time()
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    counts["gc_ms"] = counts.get("gc_ms", 0.0) + _GC["ms"]
    for k, v in _counts(dev).items():
        counts[k] = counts.get(k, 0) + v - c0[k]
    return wall, (h1 - h0) * 1e3


def _single(args) -> int:
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.train import optimizer as opt_lib, train_loop

    dev = torch.device(args.device)
    arch = get_arch("qwen1.5-4b")
    cfg = arch.full
    batch, seq = 8, 128
    if args.smoke:
        cfg = dataclasses.replace(arch.smoke, compute_dtype=torch.float32)
        batch, seq = 2, 16
    tcfg = train_loop.TrainConfig(
        optimizer=opt_lib.OptimizerConfig(lr=3e-4, warmup_steps=1,
                                          total_steps=10),
        num_microbatches=2)
    params, opt = train_loop.init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = train_loop.make_train_step(cfg, tcfg)
    data = pipeline.make_batch(pipeline.DataConfig(
        seed=0, global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size),
        0)
    walls, gcs, counts = [], [], {}
    for _ in range(args.steps):
        before = counts.get("gc_ms", 0.0)
        walls.append(_timed(lambda: step(params, opt, data), dev,
                            counts)[0])
        gcs.append(counts["gc_ms"] - before)
    rest = walls[1:]
    out = {"src": args.src, "device": str(dev), "smoke": args.smoke,
           "step_wall_ms": walls, "gc_ms": gcs,
           "median_ms": _median(rest),
           "mean_ms": sum(rest) / len(rest),
           "gc_mean_ms": sum(gcs[1:]) / len(rest),
           "counts": counts, **_card(dev)}
    print(json.dumps(out))
    return 0


def _pairs(name: str, run: dict, rounds: int, dev, reset_gc: bool = True,
           **extra) -> dict:
    """``rounds`` pairs of ``run["parent"]()`` and ``run["change"]()``,
    the order alternating, the collector run untimed before each unless
    ``reset_gc`` is false."""
    for side in ("parent", "change"):           # warm-up
        _timed(run[side], dev, {})
    walls = {"parent": [], "change": []}
    host = {"parent": [], "change": []}
    counts = {"parent": {}, "change": {}}
    for r in range(rounds):
        order = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for side in order:
            if reset_gc:
                gc.collect()
            w, h = _timed(run[side], dev, counts[side])
            walls[side].append(w)
            host[side].append(h)
    ratios = [c / p for p, c in zip(walls["parent"], walls["change"])]
    return {"measure": name, **extra, "device": str(dev),
            "parent_ms": walls["parent"], "change_ms": walls["change"],
            "parent_median_ms": _median(walls["parent"]),
            "change_median_ms": _median(walls["change"]),
            "ratios": ratios, "median_ratio": _median(ratios),
            "change_slower_in": sum(r > 1 for r in ratios),
            "parent_host_median_ms": _median(host["parent"]),
            "change_host_median_ms": _median(host["change"]),
            "counts": counts, "pairs": rounds, **_card(dev)}


def _profile(side: str, fn, dev, top: int) -> None:
    """One more call of ``fn`` under ``cProfile``: its ``top`` functions
    by own time, as one JSON line (calls, own and cumulative ms)."""
    import cProfile
    import pstats

    import torch

    gc.collect()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(json.dumps({"profile": side, "calls": sum(
        v[1] for v in stats.values()), "functions": [
        {"fn": f"{Path(f).name}:{line}:{name}", "calls": v[1],
         "own_ms": v[2] * 1e3, "cum_ms": v[3] * 1e3}
        for (f, line, name), v in rows]}), flush=True)


def _ab(args) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import repro_torch as change
    parent = _load_parent(Path(args.parent_src).resolve())
    sides = {"change": change, "parent": parent}
    for pkg in sides.values():
        for sub in ("configs", "data.pipeline", "train.optimizer",
                    "train.train_loop", "models.model", "serve"):
            __import__(f"{pkg.__name__}.{sub}")

    def sub(side, path):
        return sys.modules[f"{sides[side].__name__}.{path}"]

    dev = torch.device(args.device)
    batch, seq = (2, 16) if args.smoke else (8, 128)

    def cfg_of(side, arch_name):
        arch = sub(side, "configs").get_arch(arch_name)
        if args.smoke:
            return dataclasses.replace(arch.smoke,
                                       compute_dtype=torch.float32)
        return arch.full

    # --- the train step: shared params and moments ----------------------
    tl, ol = sub("change", "train.train_loop"), sub("change",
                                                    "train.optimizer")
    cfg = cfg_of("change", "qwen1.5-4b")
    tcfg = tl.TrainConfig(optimizer=ol.OptimizerConfig(
        lr=3e-4, warmup_steps=1, total_steps=10), num_microbatches=2)
    params, opt = tl.init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    data = sub("change", "data.pipeline").make_batch(
        sub("change", "data.pipeline").DataConfig(
            seed=0, global_batch=batch, seq_len=seq,
            vocab_size=cfg.vocab_size), 0)
    state = {"opt": tuple(opt)}
    run = {}
    for side in sides:
        s_tl, s_ol = sub(side, "train.train_loop"), sub(side,
                                                        "train.optimizer")
        s_tcfg = s_tl.TrainConfig(optimizer=s_ol.OptimizerConfig(
            lr=3e-4, warmup_steps=1, total_steps=10), num_microbatches=2)
        step = s_tl.make_train_step(cfg_of(side, "qwen1.5-4b"), s_tcfg)

        def one(step=step, s_ol=s_ol):
            _, new_opt, _ = step(params, s_ol.OptState(*state["opt"]), data)
            state["opt"] = tuple(new_opt)
        run[side] = one
    print(json.dumps(_pairs("train_step", run, args.rounds, dev,
                            not args.shared_gc, arch="qwen1.5-4b",
                            smoke=args.smoke)),
          flush=True)
    if args.profile:
        for side in ("parent", "change"):
            _profile(side, run[side], dev, args.profile)
    del params, opt, state, run
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- serving's decode token -----------------------------------------
    for arch_name in ("qwen1.5-4b", "granite-moe-3b-a800m"):
        cfg = cfg_of("change", arch_name)
        params = sub("change", "models.model").init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompts = torch.from_numpy(sub("change", "data.pipeline").make_batch(
            sub("change", "data.pipeline").DataConfig(
                seed=0, global_batch=8, seq_len=seq,
                vocab_size=cfg.vocab_size), 0)["tokens"]).to(dev)
        run = {}
        for side in sides:
            srv = sub(side, "serve")
            eng = srv.ServeEngine(cfg_of(side, arch_name), params,
                                  srv.ServeConfig(batch_size=8,
                                                  max_len=seq + 512),
                                  device=dev)
            cache = eng.fresh_cache()
            _, cache = eng.prefill_fn(params, {"tokens": prompts},
                                      cache=cache)
            tok = prompts[:, -1:]
            pos = {"n": seq}

            def tokens(eng=eng, cache=cache, tok=tok, pos=pos):
                for _ in range(8):
                    eng.decode_fn(params, tok, cache, pos["n"])
                    pos["n"] += 1
            run[side] = tokens
        print(json.dumps(_pairs("decode_8_tokens", run, args.decode_rounds,
                                dev, not args.shared_gc, arch=arch_name,
                                smoke=args.smoke)),
              flush=True)
        del params, run
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--parent-src", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--decode-rounds", type=int, default=6)
    ap.add_argument("--shared-gc", action="store_true",
                    help="do not run the collector before each timed call")
    ap.add_argument("--profile", type=int, default=0,
                    help="after the train pairs, profile one step of "
                    "each side and print its N costliest functions")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("train_step_wall.py: no CUDA device", file=sys.stderr)
            return 1
    gc.callbacks.append(_gc_timer)
    return _ab(args) if args.parent_src else _single(args)


if __name__ == "__main__":
    sys.exit(main())
