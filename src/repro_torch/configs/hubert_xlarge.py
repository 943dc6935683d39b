"""hubert-xlarge [audio] — 48L d=1280 16H (MHA kv=16) d_ff=5120, vocab=504
(cluster targets), encoder-only (w2v2 arch).  The conv feature extractor is
a STUB: input_specs provide precomputed frame embeddings (B, S, 512).
[arXiv:2106.07447; unverified]
"""
from ..models.config import ModelConfig
from .base import ArchDef, register


@register("hubert-xlarge")
def arch() -> ArchDef:
    full = ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        mlp_kind="gelu",
        encoder_only=True,
        frontend="audio",
        frontend_dim=512,
        remat="full",
    )
    smoke = ModelConfig(
        name="hubert-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=32,
        mlp_kind="gelu",
        encoder_only=True,
        frontend="audio",
        frontend_dim=24,
        kv_chunk=64,
    )
    return ArchDef(
        name="hubert-xlarge",
        full=full,
        smoke=smoke,
        microbatches={"train_4k": 2},
        notes="Encoder-only: decode_32k / long_500k skipped per spec. "
              "train_4k = 4096 audio frames; labels are k-means targets.",
    )
