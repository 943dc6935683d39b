"""The synchronised timer of the dispatch cost model's tuner.

Only :func:`timed_best_of` is ported, the counterpart of
``repro.core.tuner.timed_best_of``: ``EngineCostModel.measure`` calibrates
through it.  The rest of the reference's tuner (the persistent table of
measured dispatch decisions, ``autotune=True``) waits for the ROADMAP item
"Tuner and cost model, re-derived for the H100".
"""
from __future__ import annotations

import time
from typing import Any, Callable, List

import torch


def _cuda_devices(out: Any, found: List[torch.device]) -> List[torch.device]:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists
    and dict values are walked; a ``torch.device`` stands for itself),
    each once."""
    if isinstance(out, torch.device):
        if out.type == "cuda" and out not in found:
            found.append(out)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    else:
        dev = getattr(out, "device", None)
        if (isinstance(dev, torch.device) and dev.type == "cuda"
                and dev not in found):
            found.append(dev)
    return found


def synchronize(out: Any) -> Any:
    """Wait until the card has finished the work behind ``out``: a
    ``torch.cuda.synchronize`` of each CUDA device that a tensor in
    ``out`` lies on (or that ``out`` names).  CPU tensors need nothing.
    Returns ``out``."""
    for dev in _cuda_devices(out, []):
        torch.cuda.synchronize(dev)
    return out


def timed_best_of(
    fn: Callable[[], Any], repeats: int = 3, warmup: int = 1
) -> float:
    """Best-of-``repeats`` synchronised wall time of ``fn()`` in seconds.

    A CUDA call returns once its kernels are queued; timing it without a
    synchronisation measures the enqueue, not the work.  So every call,
    warm-ups included, is followed by :func:`synchronize` on what it
    returned before the clock is read.
    """
    for _ in range(max(int(warmup), 0)):
        synchronize(fn())
    best = float("inf")
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        synchronize(fn())
        best = min(best, time.perf_counter() - t0)
    return max(best, 1e-9)
