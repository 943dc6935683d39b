"""Deterministic, restart-safe synthetic data pipeline (a numpy copy of
``repro.data.pipeline``: the same ``(seed, step, shard)`` gives the same
arrays bit for bit).

Every batch is a pure function of (seed, step, shard) via a counter-based
hash — no state to checkpoint, O(1) skip-to-step after restart, and each
data shard produces a disjoint stream.  This is the property a 1000-node
input pipeline needs: a restarted/rescheduled host reproduces exactly the
batches it would have produced.

Token streams are Zipf-ish over the vocab with local n-gram structure so
losses actually decrease during the example runs (pure-uniform tokens give
flat loss curves).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 256
    num_shards: int = 1
    # modality stubs
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0
    num_patches: int = 0


def _counter_rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    # Philox counter-based: reproducible + cheap skip-ahead
    return np.random.Generator(
        np.random.Philox(key=cfg.seed, counter=[step, shard, 0, 0])
    )


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    u = rng.random(shape)
    ranks = np.floor(vocab ** u).astype(np.int64) - 1  # log-uniform ranks
    base = np.clip(ranks, 0, vocab - 1)
    # local structure: every other token repeats its predecessor's bucket
    rolled = np.roll(base, 1, axis=-1)
    mix = rng.random(shape) < 0.3
    return np.where(mix, rolled, base).astype(np.int32)


def make_batch(cfg: DataConfig, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
    assert cfg.global_batch % cfg.num_shards == 0
    b = cfg.global_batch // cfg.num_shards
    rng = _counter_rng(cfg, step, shard)
    if cfg.frontend == "audio":
        return {
            "frames": rng.standard_normal(
                (b, cfg.seq_len, cfg.frontend_dim), dtype=np.float32
            ),
            "labels": _zipf_tokens(rng, (b, cfg.seq_len), cfg.vocab_size),
        }
    if cfg.frontend == "vision":
        s_text = cfg.seq_len - cfg.num_patches
        return {
            "tokens": _zipf_tokens(rng, (b, s_text), cfg.vocab_size),
            "patches": rng.standard_normal(
                (b, cfg.num_patches, cfg.frontend_dim), dtype=np.float32
            ),
        }
    return {"tokens": _zipf_tokens(rng, (b, cfg.seq_len), cfg.vocab_size)}


def batch_iterator(
    cfg: DataConfig, start_step: int = 0, shard: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step, shard)
        step += 1
