"""zamba2-1.2b [hybrid] — 38L d=2048, Mamba2 backbone + shared attention
block (32H, kv=32, d_ff=8192 in the shared block), ssm_state=64.
[arXiv:2411.15242; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("zamba2-1.2b")
def arch() -> ArchDef:
    full = ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        mlp_kind="swiglu",
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        hybrid_attn_every=6,
        sub_quadratic=True,
        remat="full",
    )
    smoke = ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=7,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        hybrid_attn_every=3,
        sub_quadratic=True,
        kv_chunk=64,
    )
    return ArchDef(
        name="zamba2-1.2b",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 4},
        notes="Mamba2 + shared attn; long_500k runs (sub-quadratic). The "
              "shared attention block's KV cache is the only per-token state.",
    )
