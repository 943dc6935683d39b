"""phi-3-vision-4.2b [vlm] — 32L d=3072 32H (MHA kv=32) d_ff=8192,
vocab=32064 (phi3-mini backbone) + CLIP ViT-L/14 frontend STUB: input_specs
provide precomputed patch embeddings (B, 576, 1024).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("phi-3-vision-4.2b")
def arch() -> ArchDef:
    full = ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        mlp_kind="swiglu",
        frontend="vision",
        frontend_dim=1024,
        num_patches=576,
        rope_theta=10000.0,
        remat="full",
    )
    smoke = ModelConfig(
        name="phi3v-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        mlp_kind="swiglu",
        frontend="vision",
        frontend_dim=24,
        num_patches=8,
        kv_chunk=64,
    )
    return ArchDef(
        name="phi-3-vision-4.2b",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 4},
        notes="seq_len cells include the 576 patch tokens; decode attends "
              "over [patches|text] cache. long_500k skipped (quadratic).",
    )
