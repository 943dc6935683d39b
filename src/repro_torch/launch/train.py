"""Train launcher: the train step under the fault-tolerant controller.

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> \\
        [--smoke] [--steps N] [--global-batch 8] [--seq-len 128] \\
        [--microbatches 1] [--ckpt-dir DIR] [--save-every 25] \\
        [--grad-compression] [--device cpu] [--init-device cpu]

A port of ``repro.launch.train`` on one device: random params from seed
0, AdamW (lr 3e-4, ``min(20, steps // 4)`` warm-up steps, cosine over
``--steps``), batches from ``data.pipeline`` (seed 0), a checkpoint every
``--save-every`` steps.  Runs on the card unless ``--device`` names
another; ``--smoke`` takes the arch's reduced config at fp32 compute.
``--init-device`` draws the random params on another device than the
run's (the same values on the card and on the CPU).  A checkpoint
directory that holds a later step than 0 resumes from it.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from ..configs import get_arch
from ..data import pipeline
from ..models.config import resolve_device
from ..train import compression, controller, optimizer as opt_lib, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config at fp32 compute")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-device", default=None,
                    help="draw the random params here (default: --device)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.full
    if args.smoke:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    device = resolve_device(args.device)

    tcfg = train_loop.TrainConfig(
        optimizer=opt_lib.OptimizerConfig(
            lr=3e-4, warmup_steps=min(20, args.steps // 4),
            total_steps=args.steps),
        num_microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    dcfg = pipeline.DataConfig(
        global_batch=args.global_batch, seq_len=args.seq_len,
        vocab_size=cfg.vocab_size, frontend=cfg.frontend,
        frontend_dim=cfg.frontend_dim, num_patches=cfg.num_patches,
    )
    gen_device = resolve_device(args.init_device or args.device)
    params, opt_state = train_loop.init_train_state(
        cfg, tcfg, torch.Generator(gen_device).manual_seed(0), device)
    step = train_loop.make_train_step(cfg, tcfg)

    ctl = controller.TrainController(
        step, lambda s: pipeline.make_batch(dcfg, s),
        controller.ControllerConfig(ckpt_dir=args.ckpt_dir,
                                    save_every=args.save_every),
    )
    if tcfg.grad_compression:
        state = {"err": compression.init_error_feedback(params)}

        def step_c(p, o, b):
            p2, o2, state["err"], m = step(p, o, b, state["err"])
            return p2, o2, m
        ctl.train_step = step_c

    params, opt_state, log = ctl.run(params, opt_state, args.steps)
    print(f"trained {len(log)} steps: loss {log[0]['loss']:.3f} -> "
          f"{log[-1]['loss']:.3f}; restarts={ctl.restart_events}; "
          f"stragglers={ctl.straggler_events}")
    return log


if __name__ == "__main__":
    main()
