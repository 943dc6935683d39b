"""nemotron-4-340b [dense] — 96L d=18432 96H (GQA kv=8) d_ff=73728,
vocab=256000, squared-ReLU MLP. [arXiv:2402.16819; unverified]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("nemotron-4-340b")
def arch() -> ArchDef:
    full = ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        mlp_kind="squared_relu",
        rope_theta=10000.0,
        remat="full",
    )
    smoke = ModelConfig(
        name="nemotron-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=384,
        vocab_size=512,
        mlp_kind="squared_relu",
        kv_chunk=64,
    )
    return ArchDef(
        name="nemotron-4-340b",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 16},
        kv_cache_dtype="int8",
        notes="Largest dense cell; decode_32k bf16 KV cache (4.7 TB) exceeds "
              "pod HBM -> int8 cache. long_500k skipped (quadratic attn). "
              "NeutronSparse technique inapplicable (dense); arch runs "
              "without it (DESIGN.md §Arch-applicability).",
    )
