"""qwen1.5-4b [dense] — 40L d=2560 20H (MHA kv=20) d_ff=6912, vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("qwen1.5-4b")
def arch() -> ArchDef:
    full = ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        mlp_kind="swiglu",
        qkv_bias=True,
        rope_theta=1000000.0,
        remat="full",
    )
    smoke = ModelConfig(
        name="qwen-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        mlp_kind="swiglu",
        qkv_bias=True,
        kv_chunk=64,
    )
    return ArchDef(
        name="qwen1.5-4b",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 4},
        kv_cache_dtype="int8",
        notes="MHA (kv=heads): largest relative KV cache in the pool.",
    )
