"""LM pre-training on the deterministic synthetic pipeline with the
fault-tolerant controller (checkpoint/restart + straggler monitor).

    PYTHONPATH=src python -m repro_torch.examples.lm_training \\
        [--steps 60] [--d-model 128] [--device cpu]

A port of the repo's ``examples/lm_training.py``, with its defaults: a
4-layer dense model at fp32, AdamW, 2 microbatches, a checkpoint every 20
steps and one injected preemption half way, after which the run restores
and replays; it asserts that the loss fell.  Runs on the card unless
``--device`` names another.  ``--d-model 768 --layers 12`` gives a
~100 M-parameter model for a longer run.
"""
import argparse
import tempfile

import torch

from ..data import pipeline
from ..models.config import ModelConfig, resolve_device
from ..train import controller, optimizer as opt_lib, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="lm-example", family="dense",
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 32, 1),
        num_kv_heads=max(args.d_model // 64, 1),
        d_ff=args.d_model * 4, vocab_size=8192, kv_chunk=128,
        compute_dtype=torch.float32,
    )
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    tcfg = train_loop.TrainConfig(
        optimizer=opt_lib.OptimizerConfig(
            lr=3e-4, warmup_steps=20, total_steps=args.steps),
        num_microbatches=args.microbatches,
    )
    dcfg = pipeline.DataConfig(global_batch=args.batch, seq_len=args.seq,
                               vocab_size=cfg.vocab_size)

    params, opt_state = train_loop.init_train_state(
        cfg, tcfg, torch.Generator(device).manual_seed(0), device)
    step = train_loop.make_train_step(cfg, tcfg)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        ctl = controller.TrainController(
            step, lambda s: pipeline.make_batch(dcfg, s),
            controller.ControllerConfig(ckpt_dir=ckpt_dir, save_every=20),
        )
        # inject one preemption mid-run to demonstrate restart
        params, opt_state, log = ctl.run(
            params, opt_state, args.steps,
            failure_at=lambda s: s == args.steps // 2
            and not ctl.restart_events,
        )
    first, last = log[0], log[-1]
    print(f"steps {len(log)} (restarts at {ctl.restart_events}, "
          f"stragglers {ctl.straggler_events})")
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f}; "
          f"median step {sorted(l['dt'] for l in log)[len(log) // 2] * 1e3:.0f} ms")
    assert last["loss"] < first["loss"]
    return log


if __name__ == "__main__":
    main()
