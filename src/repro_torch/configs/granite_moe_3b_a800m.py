"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) d_ff=512 (per
expert), vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("granite-moe-3b-a800m")
def arch() -> ArchDef:
    full = ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        mlp_kind="swiglu",
        moe_num_experts=40,
        moe_top_k=8,
        moe_d_expert=512,
        rope_theta=10000.0,
        remat="full",
    )
    smoke = ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=512,
        mlp_kind="swiglu",
        moe_num_experts=8,
        moe_top_k=2,
        moe_d_expert=32,
        kv_chunk=64,
    )
    return ArchDef(
        name="granite-moe-3b-a800m",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 4},
        notes="40-expert top-8: highest dispatch fan-out in the pool.",
    )
