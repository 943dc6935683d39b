"""Top-level model: embedding/frontend + stack + head; forward, loss and the
serve steps.  A port of ``repro.models.model``.

Batch conventions (all synthetic-friendly; see ``data/pipeline.py``):
  LM families : {"tokens": (B, S) int}            loss = next-token CE
  audio       : {"frames": (B, S, F), "labels": (B, S) int}  frame CE
  vlm         : {"tokens": (B, S_text), "patches": (B, P, F)}   text CE

Batches may hold tensors or numpy arrays; they move to the params' device.
``loss_fn`` is differentiable (``train/`` takes its gradient).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import (
    constrain, dtensor_mesh, gather_weight, grad_reduced, logical_placements,
    to_placements,
)
from . import layers, transformer
from .config import ModelConfig, resolve_device
from .layers import Init

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> Params:
    """Random params with the reference's keys, shapes, dtypes and scales,
    drawn from ``generator`` (on the generator's device) and placed on
    ``device`` (``"cuda"`` unless named; raises without a card).
    ``device="meta"`` with ``generator=None`` gives shapes and dtypes only.
    """
    meta = device is not None and torch.device(device).type == "meta"
    device = torch.device("meta") if meta else resolve_device(device)
    if (generator is None) != meta:
        raise ValueError("init_params takes a torch.Generator, or "
                         "generator=None with device='meta'")
    init = Init(generator, device, cfg.param_dtype)
    p: Params = {
        "embed": {"table": init.normal((cfg.padded_vocab, cfg.d_model), 0.02)},
        "stack": transformer.init_stack(init, cfg),
        "final_norm": layers.init_rms_norm(init, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["head"] = {
            "lm_head": init.normal((cfg.d_model, cfg.padded_vocab),
                                   1.0 / np.sqrt(cfg.d_model))
        }
    if cfg.frontend != "none":
        p["frontend"] = {
            "frontend_proj": init.normal((cfg.frontend_dim, cfg.d_model),
                                         1.0 / np.sqrt(cfg.frontend_dim))
        }
    return p


def params_device(params: Params) -> torch.device:
    return params["embed"]["table"].device


def _on(x, device) -> torch.Tensor:
    if hasattr(x, "placements"):  # a placed batch stays where it is
        return x
    return torch.as_tensor(x).to(device)


def _embed(params: Params, tokens: torch.Tensor, cd) -> torch.Tensor:
    table = params["embed"]["table"]
    if hasattr(table, "placements"):
        return _embed_sharded(table.to(cd), tokens)
    # index, then cast: the same values as the reference's cast-then-index,
    # without a compute-dtype copy of the whole table per call
    return table[tokens.long()].to(cd)


def _embed_sharded(table: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """The lookup of a partitioned program, as XLA partitions the
    reference's cast-then-index: the token ids gathered over the axes
    that split the table's d_model, each device's rows of its vocab slice
    looked up (0 for an id outside it) on its d_model slice, partial over
    the axes that split the vocab; the caller's constraint sums them and
    moves them to the batch split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    (n_v, _), (v0, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    tok_pl, out_pl = [], []
    for tp, kp in zip(table.placements, tokens.placements):
        if tp.is_shard(1):
            tok_pl.append(Replicate())
            out_pl.append(Shard(tokens.ndim))
        elif tp.is_shard(0):
            tok_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            tok_pl.append(kp)
            out_pl.append(kp)
    tokens = to_placements(tokens, tuple(tok_pl))

    def lookup(tab, tok):
        idx = tok.long() - v0
        inside = (idx >= 0) & (idx < n_v)
        rows = torch.nn.functional.embedding(idx.clamp(0, n_v - 1), tab)
        return torch.where(inside[..., None], rows, 0.0).to(tab.dtype)

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tuple(table.placements), tuple(tok_pl)),
                     device_mesh=mesh)(table, tokens)


def _embed_batch(
    params: Params, batch: Dict[str, Any], cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D) in compute dtype, token positions (S,))."""
    cd = cfg.compute_dtype
    dev = params_device(params)
    if cfg.frontend == "audio":
        x = constrain(_on(batch["frames"], dev).to(cd)
                      @ gather_weight(params["frontend"]["frontend_proj"],
                                      cd),
                      "batch", "seq", None)
    elif cfg.frontend == "vision":
        patches = constrain(
            _on(batch["patches"], dev).to(cd)
            @ gather_weight(params["frontend"]["frontend_proj"], cd),
            "batch", "seq", None)
        text = constrain(_embed(params, _on(batch["tokens"], dev), cd),
                         "batch", "seq", None)
        x = torch.cat([patches, text], dim=1)
    else:
        x = _embed(params, _on(batch["tokens"], dev), cd)
    positions = torch.arange(x.shape[1], device=dev)
    return constrain(x, "batch", "seq", None), positions


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        w = gather_weight(params["embed"]["table"], x.dtype).t()
    else:
        w = gather_weight(params["head"]["lm_head"], x.dtype)
    logits = (grad_reduced(x) @ w).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding columns
        if dtensor_mesh() is not None:
            # a vocab-split DTensor takes no in-place write to a slice
            logits = torch.where(_vocab_ids(logits) < cfg.vocab_size,
                                 logits, layers.NEG)
        else:
            logits[..., cfg.vocab_size:] = layers.NEG
    return constrain(logits, "batch", "seq", "vocab")


def _vocab_ids(logits: torch.Tensor) -> torch.Tensor:
    """The vocab index of each entry of the last dimension of ``logits``
    (V,), split over the mesh as that dimension is (a DTensor), or a
    plain ``arange``."""
    v = logits.shape[-1]
    if not hasattr(logits, "placements"):
        return torch.arange(v, device=logits.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    last = logits.ndim - 1
    pl = tuple(Shard(0) if p.is_shard(last) else Replicate()
               for p in logits.placements)
    mesh = logits.device_mesh
    (n,), (off,) = compute_local_shape_and_global_offset((v,), mesh, pl)
    local = torch.arange(off, off + n, device=logits.to_local().device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size([v]), stride=(1,))


def forward(
    params: Params, batch: Dict[str, Any], cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits fp32, aux_loss)."""
    x, positions = _embed_batch(params, batch, cfg)
    x, _, aux = transformer.apply_stack(params["stack"], x, cfg, positions)
    return _head(params, x, cfg), aux


def loss_fn(
    params: Params, batch: Dict[str, Any], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(params, batch, cfg)
    dev = logits.device
    if cfg.frontend == "audio":
        labels = _on(batch["labels"], dev).long()
        preds = logits
    elif cfg.frontend == "vision":
        # next-token loss on the text segment only
        preds = logits[:, cfg.num_patches:][:, :-1]
        labels = _on(batch["tokens"], dev)[:, 1:].long()
    else:
        preds = logits[:, :-1]
        labels = _on(batch["tokens"], dev)[:, 1:].long()
    valid = torch.ones_like(labels, dtype=torch.float32)
    if dtensor_mesh() is not None:
        logz, gold = _vocab_parallel_stats(preds, labels)
    else:
        logz = torch.logsumexp(preds, dim=-1)
        gold = torch.gather(preds, -1, labels[..., None])[..., 0]
    ce = (logz - gold) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = ce.sum() / denom
    total = loss + cfg.moe_aux_weight * aux
    if dtensor_mesh() is not None:
        total, loss, aux, denom = (_replicated(t)
                                   for t in (total, loss, aux, denom))
    return total, {"ce": loss, "aux": aux, "tokens": denom}


def _vocab_parallel_stats(preds: torch.Tensor, labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logsumexp and the gold logit of a vocab-split ``preds`` (a
    DTensor): a max, a sum of exponentials and a masked sum over each
    device's vocab slice, each summed (or maxed) over TP, as XLA
    partitions the reference's softmax."""
    spec = logical_placements(preds.ndim - 1, ("batch", None))
    m = _vocab_max(preds.detach(), spec)
    sumexp = _vocab_sumexp(preds, m)
    if spec is not None:
        sumexp = to_placements(sumexp, spec)
    logz = m + torch.log(sumexp)
    hit = _vocab_ids(preds) == labels[..., None]
    gold = torch.where(hit, preds, 0.0).sum(dim=-1)
    if spec is not None:
        gold = to_placements(gold, spec)
    return logz, gold


def _vocab_max(preds: torch.Tensor, spec) -> torch.Tensor:
    """The max over the vocab of a vocab-split DTensor: each device's
    max of its slice, then a max over TP (DTensor's own ``amax`` would
    gather the slices first)."""
    from torch.distributed.tensor import DTensor, Partial

    last = preds.ndim - 1
    local = preds.to_local().amax(dim=-1)
    pl = tuple(Partial("max") if p.is_shard(last) else p
               for p in preds.placements)
    m = DTensor.from_local(local, preds.device_mesh, pl, run_check=False,
                           shape=preds.shape[:-1],
                           stride=torch.empty(preds.shape[:-1],
                                              device="meta").stride())
    return to_placements(m, spec) if spec is not None else m


def _vocab_sumexp(preds: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``exp(preds - m).sum(-1)`` of a vocab-split DTensor as each
    device's sum over its slice, partial over TP (DTensor's broadcast
    against ``m`` would gather the slices first)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    last = preds.ndim - 1
    out = [Partial() if p.is_shard(last) else p for p in preds.placements]
    body = local_map(lambda p, m: torch.exp(p - m[..., None]).sum(dim=-1),
                     out_placements=out,
                     in_placements=(tuple(preds.placements),
                                    tuple(m.placements)),
                     device_mesh=preds.device_mesh)
    return body(preds, m)


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor scalar summed (or taken) over the mesh: replicated."""
    if not hasattr(t, "placements"):
        return t
    from torch.distributed.tensor import Replicate

    return to_placements(t, (Replicate(),) * t.device_mesh.ndim)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Any:
    """A zeroed KV/SSM cache on ``device`` (``"cuda"`` unless named)."""
    dtype = dtype or cfg.compute_dtype
    return transformer.init_stack_cache(cfg, batch, max_len, dtype,
                                        resolve_device(device))


def prefill(
    params: Params, batch: Dict[str, Any], cfg: ModelConfig,
    cache: Any,
) -> Tuple[torch.Tensor, Any]:
    """Run the prompt through the stack filling the cache (in place).

    Returns (last-position logits (B, V), cache)."""
    x, positions = _embed_batch(params, batch, cfg)
    x, cache, _ = transformer.apply_stack(
        params["stack"], x, cfg, positions, cache=cache, cache_len=0,
    )
    logits = _head(params, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(
    params: Params,
    token: Any,      # (B, 1) int
    cache: Any,
    cache_len: Any,  # int or 0-d tensor — current valid cache length
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Any]:
    """One-token decode against a cache of length ``cache_len``.

    The position is ``cache_len`` unclamped, as in the reference; the cache
    write clamps (``layers.apply_attention``).  Returns (logits (B, V),
    cache updated in place)."""
    dev = params_device(params)
    cache_len = int(cache_len)
    x = _embed(params, _on(token, dev), cfg.compute_dtype)
    x = constrain(x, "batch", None, None)
    positions = cache_len + torch.arange(1, device=dev)
    x, cache, _ = transformer.apply_stack(
        params["stack"], x, cfg, positions, cache=cache, cache_len=cache_len
    )
    logits = _head(params, x, cfg)
    return logits[:, 0], cache
