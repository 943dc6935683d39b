"""llama4-scout-17b-a16e [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 16 experts top-1 + shared expert (early fusion).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("llama4-scout-17b-a16e")
def arch() -> ArchDef:
    full = ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        mlp_kind="swiglu",
        moe_num_experts=16,
        moe_top_k=1,
        moe_d_expert=8192,
        moe_shared_expert=True,
        rope_theta=500000.0,
        remat="full",
    )
    smoke = ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        mlp_kind="swiglu",
        moe_num_experts=4,
        moe_top_k=1,
        moe_d_expert=64,
        moe_shared_expert=True,
        kv_chunk=64,
    )
    return ArchDef(
        name="llama4-scout-17b-a16e",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 8},
        notes="MoE dispatch = NeutronSparse block-sparse SpMM (top-1, 16e).",
    )
