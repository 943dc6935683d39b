"""Model configuration shared by the model zoo, configs/, and the launcher.

A copy of ``repro.models.config.ModelConfig`` with torch dtypes: the
same fields, defaults and derived methods, so that the arch files in
``repro_torch.configs`` copy over field for field.  ``remat="full"``
recomputes each layer group in the backward (``transformer.apply_stack``);
at inference, and with a cache, it changes nothing.  ``scan_layers`` and
``attn_unroll`` are kept so the fields copy over; they change nothing.
``resolve_device`` is the device rule of the LM entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm

    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    mlp_kind: str = "swiglu"  # swiglu | squared_relu | geglu | gelu

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_pattern: Tuple[str, ...] = ("global",)  # repeating per-layer pattern
    window: Optional[int] = None                 # local-attention window
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    kv_chunk: int = 1024
    tie_embeddings: bool = False

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_d_expert: int = 0
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = False
    moe_aux_weight: float = 0.01
    moe_impl: str = "dense"  # dense (GSPMD) | shard_map (local dispatch)

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    hybrid_attn_every: int = 0  # zamba2: a shared attn block every N layers

    # frontends ([audio]/[vlm] backbones: modality stub provides embeddings)
    encoder_only: bool = False
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0
    num_patches: int = 0    # vision: patch-token count inside seq_len

    norm_eps: float = 1e-6

    # runtime policy
    param_dtype: object = torch.float32
    compute_dtype: object = torch.bfloat16
    remat: str = "full"  # none | full
    sub_quadratic: bool = False  # qualifies for long_500k
    # the reference's analysis knobs (layer scan, KV-chunk unroll); the
    # port runs both loops in Python and reads neither
    scan_layers: bool = True
    attn_unroll: int = 1

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding to a multiple of 128 so the
        embedding/logits can shard evenly over any TP degree <= 128.
        Padded logit columns are masked to -1e30 in the head."""
        return ((self.vocab_size + 127) // 128) * 128

    def ssm_spec(self):
        from .ssm import SSMSpec
        return SSMSpec(
            d_model=self.d_model,
            state_dim=self.ssm_state,
            head_dim=self.ssm_head_dim,
            expand=self.ssm_expand,
            chunk=self.ssm_chunk,
        )

    def moe_spec(self):
        from .moe import MoESpec
        return MoESpec(
            d_model=self.d_model,
            d_expert=self.moe_d_expert or self.d_ff,
            num_experts=self.moe_num_experts,
            top_k=self.moe_top_k,
            capacity_factor=self.moe_capacity_factor,
            mlp_kind=self.mlp_kind,
            shared_expert=self.moe_shared_expert,
            d_shared=self.d_ff,
            impl=self.moe_impl,
        )

    def group_pattern(self) -> Tuple[str, ...]:
        """The repeating layer pattern the stack scans over."""
        if self.family == "moe":
            return ("attn_moe",)
        if self.family == "ssm":
            return ("ssm",)
        if self.family == "hybrid":
            k = max(self.hybrid_attn_every, 1)
            return ("ssm",) * (k - 1) + ("shared_attn",)
        # dense / audio / vlm: the attention pattern (e.g. local/global)
        return tuple("attn" for _ in self.attn_pattern) if self.attn_pattern else ("attn",)

    def has_shared_attn(self) -> bool:
        return "shared_attn" in self.group_pattern()

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.group_pattern()
        full = pat * (self.num_layers // len(pat)) + pat[: self.num_layers % len(pat)]
        return full

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        emb = self.padded_vocab * d
        n += emb if self.tie_embeddings else 2 * emb
        if self.frontend != "none":
            n += self.frontend_dim * d
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        glu = self.mlp_kind in ("swiglu", "geglu")
        mlp = d * self.d_ff * (3 if glu else 2)
        moe = 0
        if self.moe_num_experts:
            de = self.moe_d_expert or self.d_ff
            moe = self.moe_num_experts * d * de * (3 if glu else 2) + d * self.moe_num_experts
            if self.moe_shared_expert:
                moe += d * self.d_ff * 3
        ssm_n = 0
        if self.ssm_state:
            spec = self.ssm_spec()
            di = spec.d_inner
            ssm_n = d * (2 * di + 2 * spec.state_dim + spec.num_heads) + di * d \
                + spec.d_conv * (di + 2 * spec.state_dim)
        for kind in self.layer_kinds():
            if kind == "attn":
                n += attn + mlp
            elif kind == "attn_moe":
                n += attn + moe
            elif kind == "ssm":
                n += ssm_n
            elif kind == "shared_attn":
                n += d * d  # adapter only; shared block counted once below
        if self.has_shared_attn():
            n += attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.moe_num_experts:
            return self.param_count()
        d = self.d_model
        de = self.moe_d_expert or self.d_ff
        glu = self.mlp_kind in ("swiglu", "geglu")
        per_layer_all = self.moe_num_experts * d * de * (3 if glu else 2)
        per_layer_active = self.moe_top_k * d * de * (3 if glu else 2)
        n_moe_layers = sum(1 for k in self.layer_kinds() if k == "attn_moe")
        return self.param_count() - n_moe_layers * (per_layer_all - per_layer_active)


def resolve_device(device=None) -> torch.device:
    """The device of an LM entry point: ``"cuda"`` unless the caller names
    another.  Raises when CUDA is asked for and none is available; there is
    no quiet CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device
