"""AdamW with a cosine schedule, global-norm clipping and a configurable
moment dtype: a port of ``repro.train.optimizer``.

States are plain trees that mirror the params (nested dicts of tensors),
with an ``OptState`` ``NamedTuple`` on top, so ``checkpoint/`` names its
leaves as the reference does (``1_step``, ``1_m_...``, ``1_v_...``).  The
step count, the learning rate and the clip scale stay 0-d tensors on the
params' device: a step never waits for the host.

The arithmetic is the reference's fp32 formula, leaf by leaf, but the
update runs in place: params and moments are overwritten, and a leaf is
walked in flat chunks of at most ``CHUNK`` elements, so the temporaries
stay two chunks in size whatever the leaf (the reference's ``upd`` makes
about eight fp32 temporaries of each leaf; for a stacked 708 M-element
leaf, 2.8 GB each, that would not fit beside the state of a 4 B-parameter
model on an 80 GB card).

Weight decay follows the reference's rule, ``p.ndim >= 2``: the stacked
layers' 1-D norm scales and biases are 2-D once stacked and decay, the
final norm's do not (``ROADMAP.md``, reference caveat C16).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Tuple

import torch

CHUNK = 1 << 26   # elements a leaf is updated in at a time (256 MB fp32)


# ---------------------------------------------------------------------------
# trees: nested dicts (and NamedTuples) of tensors, in the reference's
# flatten order (dict keys sorted)
# ---------------------------------------------------------------------------
def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of ``tree`` and ``rest``; dicts keep
    ``tree``'s key order, tuples and NamedTuples their type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple):
        parts = [tree_map(fn, *subs) for subs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the params' device
    m: Any
    v: Any


def init_opt_state(params: Any, cfg: OptimizerConfig) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` beside each param leaf."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    device = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def schedule(step: Any, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac * lr``; fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in
    flatten order; fp32.  On DTensors each device sums its shards (a
    replicated dimension once, on its first device) and the sum is
    all-reduced over the mesh, one scalar per mesh axis."""
    leaves = tree_leaves(tree)
    if hasattr(leaves[0], "placements"):
        return _global_norm_sharded(leaves)
    total = None
    for g in leaves:
        sq = sum(torch.sum(torch.square(c.float())) for c in _chunks(g))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _global_norm_sharded(leaves: List[Any]) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = None
    for g in leaves:
        local = g.to_local()
        sq = sum(torch.sum(torch.square(c.float())) for c in _chunks(local))
        if any(not p.is_shard() and coord[i]
               for i, p in enumerate(g.placements)):
            sq = sq * 0.0    # a replica: its first device counts it
        total = sq if total is None else total + sq
    total = DTensor.from_local(total, mesh, (Partial(),) * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.redistribute(mesh, (Replicate(),) * mesh.ndim))


def _local(t: Any) -> Any:
    """A DTensor's own block (a replicated scalar's value); ``t`` else."""
    return t.to_local() if hasattr(t, "placements") else t


def _update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, scale: torch.Tensor, lr: torch.Tensor,
                 b1c: torch.Tensor, b2c: torch.Tensor,
                 cfg: OptimizerConfig) -> None:
    """The reference's ``upd`` in place, chunk by chunk."""
    decay = p.ndim >= 2
    for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                              _chunks(v)):
        g32 = gc.float() * scale                             # temporary 1
        m32 = mc.float().mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v32 = vc.float().mul_(cfg.b2).add_(
            g32.mul_(g32), alpha=1 - cfg.b2)
        denom = torch.div(v32, b2c).sqrt_().add_(cfg.eps)    # temporary 2
        delta = torch.div(m32, b1c, out=g32).div_(denom)
        p32 = pc.float()
        if decay:
            delta.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(delta.mul_(lr))
        for dst, src in ((pc, p32), (mc, m32), (vc, v32)):
            if dst.data_ptr() != src.data_ptr():   # not fp32: copy back
                dst.copy_(src)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: OptState,
                  cfg: OptimizerConfig
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``params`` and the moments are updated in place
    and returned (the same tensors); metrics are 0-d device tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    # on DTensors the update is elementwise on each device's shards
    scalars = [_local(t) for t in (scale, lr, b1c, b2c)]
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        _update_leaf(_local(p), _local(g), _local(m), _local(v), *scalars,
                     cfg)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, m=state.m, v=state.v), metrics
