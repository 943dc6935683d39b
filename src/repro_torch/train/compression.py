"""Gradient compression with error feedback (int8 quantisation): a port of
``repro.train.compression``.

Each leaf is quantised to int8 against its own absmax (``round`` is
half-to-even, as ``jnp.round``), dequantised, and the residual is carried
into the next step, so the compression bias telescopes away (Seide et al.,
1-bit SGD; Karimireddy et al. 2019).  The port runs on one device and
sends nothing: what it keeps is the arithmetic, which decides the update.
``quantize``/``dequantize`` are separate so that tests can bound the
per-step error and check the telescoping.  On DTensors (a partitioned
step) the arithmetic is elementwise on each shard but for the absmax, a
max over the leaf that DTensor reduces over the mesh.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .optimizer import tree_map


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.max(torch.abs(g)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads_with_feedback(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (dequantised grads to apply, new error feedback tree).

    ``grads``/``error`` are matching trees; ``error`` starts as
    :func:`init_error_feedback`'s zeros."""
    new_error = []

    def one(g, e):
        g32 = g.to(torch.float32) + e.to(torch.float32)
        q, scale = _quantize_leaf(g32)
        deq = _dequantize_leaf(q, scale)
        new_error.append((g32 - deq).to(e.dtype))
        return deq.to(g.dtype)

    applied = tree_map(one, grads, error)
    errs = iter(new_error)   # tree_map visits both trees in one order
    return applied, tree_map(lambda _: next(errs), grads)


def init_error_feedback(grads_like: Any) -> Any:
    """fp32 zeros beside each leaf of ``grads_like``."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads_like)

