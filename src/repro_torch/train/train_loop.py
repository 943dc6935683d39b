"""Train-step factory: gradient accumulation over microbatches, mixed
precision (the model's compute dtype), optional gradient compression,
AdamW.  A port of ``repro.train.train_loop``.

``make_train_step`` returns a function
    (params, opt_state, batch[, error_fb]) -> (params, opt_state[, error_fb], metrics)
as the reference's does.  Params are leaf tensors that require grad
(:func:`init_train_state` makes them so); the step runs the forward and
backward with grad enabled and the update under ``torch.no_grad()``,
in place: the returned params and moments are the tensors passed in.

Microbatches run as a Python loop (the reference scans, or loops with
``unroll_microbatches``; both give the same numbers, so the port reads the
flag and changes nothing).  With ``n > 1`` microbatches each one's
gradient is divided by ``n`` and added into an fp32 accumulator, the
reference's ``acc + g / n``, leaf by leaf as the backward finishes each
leaf (a post-accumulate hook), so a step holds one set of gradients beside
the accumulator's rather than two.  With ``n == 1`` the gradients are the
backward's own, in the params' dtype, as the reference's are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models import model as model_lib
from ..models.config import ModelConfig
from . import compression, optimizer as opt_lib
from .optimizer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt_lib.OptimizerConfig = opt_lib.OptimizerConfig()
    num_microbatches: int = 1
    grad_compression: bool = False
    # the reference's analysis mode (a Python loop so XLA's cost analysis
    # counts every microbatch); the port always loops, so it changes nothing
    unroll_microbatches: bool = False


def _split_micro(batch: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """``n`` microbatches of consecutive rows, as the reference's reshape
    to ``(n, b // n, ...)`` gives.  A placed batch (DTensors split over
    the batch axes) is moved so that each microbatch is split over them
    in turn."""
    if any(hasattr(x, "placements") for x in batch.values()):
        return _split_micro_local(batch, n)
    b = len(next(iter(batch.values())))
    if any(len(x) != b for x in batch.values()) or b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    m = b // n
    return [{k: x[i * m:(i + 1) * m] for k, x in batch.items()}
            for i in range(n)]


def _split_micro_local(batch: Dict[str, Any], n: int
                       ) -> List[Dict[str, Any]]:
    from torch.distributed.tensor import Replicate, Shard

    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        # (n, b // n, ...) with the batch split moved to each microbatch's
        # rows, so microbatch i holds rows i*m..(i+1)*m: an all-to-all
        # where n divides over the batch axes, else gathered and sliced
        mesh = x.device_mesh
        split = [i for i, p in enumerate(x.placements) if p.is_shard(0)]
        if n % math.prod(mesh.size(i) for i in split):
            x = x.redistribute(mesh, tuple(
                Replicate() if i in split else p
                for i, p in enumerate(x.placements)))
        xr = x.reshape((n, b // n) + tuple(x.shape[1:]))
        xr = xr.redistribute(mesh, tuple(
            Shard(1) if i in split else p
            for i, p in enumerate(xr.placements)))
        for i in range(n):
            out[i][k] = xr[i]
    return out


def _accumulate_into(acc: List[Optional[torch.Tensor]], i: int, n: int
                     ) -> Callable[[torch.Tensor], None]:
    """A post-accumulate hook that moves leaf ``i``'s fresh gradient into
    ``acc[i]`` as ``acc + g.float() / n`` and frees ``p.grad``."""
    def hook(p: torch.Tensor) -> None:
        g = _as_param(p.grad, p).to(torch.float32).div_(n)
        if acc[i] is None:
            acc[i] = g        # 0 + g / n
        else:
            acc[i].add_(g)
        p.grad = None
    return hook


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its param's placements: a partial sum is
    reduced (all-reduced onto a replicated leaf, reduce-scattered onto a
    split one), as XLA reduces each gradient to its param's sharding."""
    if not hasattr(g, "placements") or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _grads(params: Any, batch: Dict[str, Any], cfg: ModelConfig, n: int
           ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``loss_fn`` over ``n`` microbatches of ``batch``:
    the mean of the microbatch losses and of their gradients (fp32 when
    ``n > 1``)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    if n == 1:
        with torch.enable_grad():
            loss, _ = model_lib.loss_fn(params, batch, cfg)
            loss.backward()
        flat = [_as_param(p.grad, p) if p.grad is not None
                else torch.zeros_like(p) for p in leaves]
        for p in leaves:
            p.grad = None
        loss = loss.detach()
    else:
        acc: List[Optional[torch.Tensor]] = [None] * len(leaves)
        hooks = [p.register_post_accumulate_grad_hook(
            _accumulate_into(acc, i, n)) for i, p in enumerate(leaves)]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        try:
            for micro in _split_micro(batch, n):
                with torch.enable_grad():
                    micro_loss, _ = model_lib.loss_fn(params, micro, cfg)
                    micro_loss.backward()
                loss = loss + micro_loss.detach() / n
        finally:
            for h in hooks:
                h.remove()
        flat = [a if a is not None
                else torch.zeros_like(p, dtype=torch.float32)
                for a, p in zip(acc, leaves)]
    by_leaf = {id(p): g for p, g in zip(leaves, flat)}
    return loss, tree_map(lambda p: by_leaf[id(p)], params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[..., Tuple[Any, ...]]:
    n = tcfg.num_microbatches

    def train_step(params, opt_state, batch, error_fb=None):
        loss, grads = _grads(params, batch, cfg, n)
        new_error = error_fb
        if tcfg.grad_compression:
            if error_fb is None:
                raise ValueError("pass error_fb when compression is on")
            grads, new_error = compression.compress_grads_with_feedback(
                grads, error_fb)
        params, opt_state, om = opt_lib.apply_updates(
            params, grads, opt_state, tcfg.optimizer)
        metrics = {"loss": loss, **om}
        if tcfg.grad_compression:
            return params, opt_state, new_error, metrics
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator], device=None
                     ) -> Tuple[Any, opt_lib.OptState]:
    """Random params (``model.init_params``: on ``device``, ``"cuda"``
    unless named) as leaf tensors that require grad, and zero moments."""
    params = model_lib.init_params(cfg, generator, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, opt_lib.init_opt_state(params, tcfg.optimizer)
