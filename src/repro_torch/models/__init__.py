"""Model zoo (the LM stack's inference path) and the sparse graph layers."""
from . import config, layers, model, moe, ssm, transformer
from .config import ModelConfig
from .layers import SparseGraphAttention, SparseGraphConv

__all__ = ["config", "layers", "model", "moe", "ssm", "transformer",
           "ModelConfig", "SparseGraphAttention", "SparseGraphConv"]
