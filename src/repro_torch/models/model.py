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
    return torch.as_tensor(x).to(device)


def _embed(params: Params, tokens: torch.Tensor, cd) -> torch.Tensor:
    # index, then cast: the same values as the reference's cast-then-index,
    # without a compute-dtype copy of the whole table per call
    return params["embed"]["table"][tokens.long()].to(cd)


def _embed_batch(
    params: Params, batch: Dict[str, Any], cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D) in compute dtype, token positions (S,))."""
    cd = cfg.compute_dtype
    dev = params_device(params)
    if cfg.frontend == "audio":
        x = _on(batch["frames"], dev).to(cd) \
            @ params["frontend"]["frontend_proj"].to(cd)
    elif cfg.frontend == "vision":
        patches = _on(batch["patches"], dev).to(cd) \
            @ params["frontend"]["frontend_proj"].to(cd)
        text = _embed(params, _on(batch["tokens"], dev), cd)
        x = torch.cat([patches, text], dim=1)
    else:
        x = _embed(params, _on(batch["tokens"], dev), cd)
    positions = torch.arange(x.shape[1], device=dev)
    return x, positions


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(x.dtype).t()
    else:
        w = params["head"]["lm_head"].to(x.dtype)
    logits = (x @ w).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding columns
        logits[..., cfg.vocab_size:] = layers.NEG
    return logits


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
    valid = torch.ones(labels.shape, dtype=torch.float32, device=dev)
    logz = torch.logsumexp(preds, dim=-1)
    gold = torch.gather(preds, -1, labels[..., None])[..., 0]
    ce = (logz - gold) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = ce.sum() / denom
    total = loss + cfg.moe_aux_weight * aux
    return total, {"ce": loss, "aux": aux, "tokens": denom}


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
    positions = cache_len + torch.arange(1, device=dev)
    x, cache, _ = transformer.apply_stack(
        params["stack"], x, cfg, positions, cache=cache, cache_len=cache_len
    )
    logits = _head(params, x, cfg)
    return logits[:, 0], cache
