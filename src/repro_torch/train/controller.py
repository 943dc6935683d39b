"""Fault-tolerant training controller: a port of
``repro.train.controller``.

Wraps the train step with the operational machinery a long run needs:

- periodic checkpointing (atomic, sharded: ``checkpoint/``);
- automatic restart from the latest checkpoint on failure (failures are
  injectable for tests: the controller replays the data stream from the
  restored step, and batches are a pure function of the step, so a
  preempted run continues bit for bit);
- straggler detection: per-step wall times are ring-buffered, and a step
  slower than ``straggler_factor`` times the running median is flagged;
- step-time accounting.

A step's time ends when its loss reaches the host (``float(loss)``, which
waits for the device).  A restore puts each leaf back on the device and in
the dtype of the matching leaf of the live tree, and a leaf that required
grad requires it again.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import checkpoint as ckpt_lib
from .optimizer import tree_map


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class ControllerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    save_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 32
    max_restarts: int = 8


def _place_like(restored: Any, live: Any) -> Any:
    """``restored`` (host arrays from ``checkpoint.restore``) as tensors on
    the device and in the dtype of the matching leaves of ``live``."""
    def place(arr, like):
        t = torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
        return t.requires_grad_(like.requires_grad)
    return tree_map(place, restored, live)


class TrainController:
    def __init__(
        self,
        train_step: Callable,
        make_batch: Callable[[int], Any],  # step -> batch (deterministic!)
        cfg: ControllerConfig,
    ):
        self.train_step = train_step
        self.make_batch = make_batch
        self.cfg = cfg
        self.step_times: deque = deque(maxlen=cfg.straggler_window)
        self.straggler_events: List[int] = []
        self.restart_events: List[int] = []
        self.metrics_log: List[Dict] = []

    def _maybe_flag_straggler(self, step: int, dt: float) -> None:
        if len(self.step_times) >= 8:
            med = float(np.median(self.step_times))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(step)
        self.step_times.append(dt)

    def _restore(self, params: Any, opt_state: Any):
        step, (p, o) = ckpt_lib.restore(self.cfg.ckpt_dir,
                                        (params, opt_state))
        return step, _place_like(p, params), _place_like(o, opt_state)

    def run(
        self,
        params: Any,
        opt_state: Any,
        num_steps: int,
        start_step: int = 0,
        failure_at: Optional[Callable[[int], bool]] = None,
    ):
        """Run with restart-on-failure.  Returns (params, opt_state, log)."""
        restarts = 0
        step = start_step
        # resume from latest checkpoint if one exists
        latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if latest is not None and latest > step:
            step, params, opt_state = self._restore(params, opt_state)

        while step < num_steps:
            try:
                batch = self.make_batch(step)
                t0 = time.perf_counter()
                if failure_at and failure_at(step):
                    raise SimulatedFailure(f"injected failure at step {step}")
                out = self.train_step(params, opt_state, batch)
                params, opt_state, metrics = out[0], out[1], out[-1]
                loss = float(metrics["loss"])   # waits for the device
                dt = time.perf_counter() - t0
                self._maybe_flag_straggler(step, dt)
                self.metrics_log.append({"step": step, "loss": loss,
                                         "dt": dt})
                step += 1
                if step % self.cfg.save_every == 0:
                    ckpt_lib.save(
                        self.cfg.ckpt_dir, step, (params, opt_state),
                        keep=self.cfg.keep,
                    )
            except SimulatedFailure:
                restarts += 1
                self.restart_events.append(step)
                if restarts > self.cfg.max_restarts:
                    raise
                latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
                if latest is not None:
                    step, params, opt_state = self._restore(params,
                                                            opt_state)
                else:
                    step = start_step  # restart from scratch
        return params, opt_state, self.metrics_log
