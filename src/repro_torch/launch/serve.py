"""Serve launcher: batched prefill + greedy decode over a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <id> \\
        [--smoke] [--batch 4] [--prompt-len 16] [--gen 32] [--device cpu]

A port of ``repro.launch.serve``: random params from seed 0, random
prompts from seed 1, ``max_len = prompt_len + gen + 8``.  Runs on the card
unless ``--device`` names another; ``--smoke`` takes the arch's reduced
config at fp32 compute.
"""
import argparse
import dataclasses
import time

import torch

from ..configs import get_arch
from ..models import model as model_lib
from ..models.config import resolve_device
from ..serve import ServeConfig, ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.full
    if arch.full.encoder_only:
        raise SystemExit("encoder-only arch has no decode step")
    if args.smoke:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    device = resolve_device(args.device)

    params = model_lib.init_params(
        cfg, torch.Generator(device).manual_seed(0), device)
    eng = ServeEngine(cfg, params, ServeConfig(
        batch_size=args.batch, max_len=args.prompt_len + args.gen + 8),
        device=device)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device).manual_seed(1), device=device)
    _sync(device)
    t0 = time.perf_counter()
    tokens, meta = eng.generate(prompts, args.gen)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"{args.arch}: served {args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    return dt


if __name__ == "__main__":
    main()
