"""What every kind of load shares (``kinds/<kind>.py`` holds each kind).

A kind's ``Load`` sets the cell up (inputs from ``--seed``, the program's
plan, the warm-up of every shape the window uses), runs the measured
window, frees the program's state, and then holds what the window
produced against the plain reference (``reference.py``).  It reaches the
program only through its entry points, looked up on their modules at each
call, so that a planted fault (``faults.py``) is seen.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_graph(bench, cfg: dict, seed: int, device: torch.device):
    """``(rows, cols, vals, shape, labels)`` of the configuration's graph:
    the structure from ``generators/<generator>.py`` and the configuration's
    own seed, the values from it too where it fixes them (``"values":
    "gcn_normalised"``) and from ``seed`` otherwise (``"values": "seed"``,
    standard normal, drawn on the device).  ``labels`` is None for a graph
    without classes."""
    g = cfg["graph"]
    rows, cols, vals, shape, labels = bench.generator(g["generator"]).build(
        g, device)
    if cfg["values"] == "seed":
        vals = torch.randn(rows.size, generator=generator(device, seed),
                           device=device).cpu().numpy()
    elif cfg["values"] != "gcn_normalised" or vals is None:
        raise ValueError(f"values {cfg['values']!r} do not fit "
                         f"{g['generator']!r}")
    return rows, cols, np.asarray(vals, np.float32), shape, labels


class Load:
    """The program's matrix, set up and freed; a kind subclasses it with
    ``setup``, ``window(seconds) -> end-to-end metrics`` and
    ``check(limits) -> compared numbers``."""

    def __init__(self, bench, cfg: dict, mix: dict, seed: int,
                 device: torch.device, rec):
        self.bench, self.cfg, self.mix, self.seed = bench, cfg, mix, int(seed)
        self.device, self.rec = device, rec
        self.attempted = 0
        self.failed = 0
        self.counters: Dict[str, float] = {}

    def prepare(self):
        """The graph, then the program's plan of it, timed as ``prepare``."""
        import repro_torch.sparse as sp

        rows, cols, vals, shape, labels = build_graph(
            self.bench, self.cfg, self.seed, self.device)
        self.coo = (rows, cols, vals, shape)
        with self.rec.span("prepare"):
            self.a = sp.from_coo(rows, cols, vals, shape, device=self.device)
            sync(self.device)
        self.counters.update(m=shape[0], k=shape[1], nnz=int(rows.size))
        return labels

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.a = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
