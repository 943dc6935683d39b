"""granite-34b [dense] — 88L d=6144 48H (MQA kv=1) d_ff=24576, vocab=49152,
llama-arch code model (gpt-bigcode lineage: MQA + gelu MLP).
[arXiv:2405.04324; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("granite-34b")
def arch() -> ArchDef:
    full = ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        mlp_kind="gelu",
        rope_theta=10000.0,
        remat="full",
    )
    smoke = ModelConfig(
        name="granite34b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        mlp_kind="gelu",
        kv_chunk=64,
    )
    return ArchDef(
        name="granite-34b",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 8},
        notes="MQA (kv=1): KV cache is tiny but un-shardable over heads — "
              "decode cells shard the cache over batch only.",
    )
