"""Batched serving engine: prefill + greedy decode over a KV/SSM cache.

A port of ``repro.serve.engine``.  ``prefill_fn`` and ``decode_fn`` are
``models.model.prefill`` and ``decode_step`` bound to the config and run
under ``torch.inference_mode()``; ``generate`` is the eager decode loop.
The cache is built in ``cfg.compute_dtype`` and updated in place;
``ServeConfig.cache_dtype`` is kept for the reference's field set and
read by nothing, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from ..models import model as model_lib
from ..models.config import ModelConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8
    max_len: int = 512
    cache_dtype: Any = torch.bfloat16  # unread, as in the reference


def _inference(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return run


class ServeEngine:
    """Greedy batched generation on ``device`` (``"cuda"`` unless named;
    raises without a card).  The params must already live there."""

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig,
                 device=None):
        self.device = resolve_device(device)
        have = model_lib.params_device(params)
        if have.type != self.device.type:
            raise ValueError(
                f"params live on {have}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.prefill_fn = _inference(
            functools.partial(model_lib.prefill, cfg=cfg))
        self.decode_fn = _inference(
            functools.partial(model_lib.decode_step, cfg=cfg))

    def fresh_cache(self) -> Any:
        return model_lib.init_cache(
            self.cfg, self.scfg.batch_size, self.scfg.max_len,
            self.cfg.compute_dtype, device=self.device,
        )

    def generate(
        self, prompts: Any, num_tokens: int
    ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """prompts: (B, S_prompt) int. Greedy decode ``num_tokens``."""
        prompts = torch.as_tensor(prompts).to(self.device)
        b, s = prompts.shape
        if b != self.scfg.batch_size:
            raise ValueError(
                f"batch of {b} prompts, engine batch_size "
                f"{self.scfg.batch_size}")
        cache = self.fresh_cache()
        logits, cache = self.prefill_fn(self.params, {"tokens": prompts},
                                        cache=cache)
        tokens = [torch.argmax(logits, -1)]
        length = s
        for _ in range(num_tokens - 1):
            logits, cache = self.decode_fn(
                self.params, tokens[-1][:, None], cache, length
            )
            tokens.append(torch.argmax(logits, -1))
            length += 1
        out = torch.stack(tokens, dim=1).to(torch.int32)
        return out, {"prompt_len": s, "generated": num_tokens}
