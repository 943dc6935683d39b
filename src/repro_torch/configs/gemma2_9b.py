"""gemma2-9b [dense] — 42L d=3584 16H (GQA kv=8, head_dim=256) d_ff=14336,
vocab=256000, local+global alternating attention (window 4096), logit
softcapping (attn 50, final 30), geglu, tied embeddings.
[arXiv:2408.00118; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("gemma2-9b")
def arch() -> ArchDef:
    full = ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        mlp_kind="geglu",
        attn_pattern=("local", "global"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        tie_embeddings=True,
        rope_theta=10000.0,
        remat="full",
    )
    smoke = ModelConfig(
        name="gemma2-smoke",
        family="dense",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        mlp_kind="geglu",
        attn_pattern=("local", "global"),
        window=16,
        attn_softcap=50.0,
        final_softcap=30.0,
        tie_embeddings=True,
        kv_chunk=64,
    )
    return ArchDef(
        name="gemma2-9b",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 4},
        kv_cache_dtype="int8",
        notes="Local layers are banded-sparse (tile scheduler applies); "
              "global layers keep long_500k quadratic -> cell skipped.",
    )
