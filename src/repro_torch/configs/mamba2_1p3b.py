"""mamba2-1.3b [ssm] — 48L d=2048, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("mamba2-1.3b")
def arch() -> ArchDef:
    full = ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=1,
        num_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
        sub_quadratic=True,
        remat="full",
    )
    smoke = ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=1,
        num_kv_heads=1,
        d_ff=0,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        tie_embeddings=True,
        sub_quadratic=True,
    )
    return ArchDef(
        name="mamba2-1.3b",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 4},
        notes="Attention-free: SpMM technique inapplicable to the SSD scan "
              "(DESIGN.md §Arch-applicability); long_500k decode is O(1) "
              "state, the cell that motivates SSM support.",
    )
