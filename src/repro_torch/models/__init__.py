"""Model zoo (the LM stack's inference path) and the sparse graph layers
and models."""
from . import config, layers, model, moe, ssm, transformer, unimp
from .config import ModelConfig
from .layers import GraphTransformerConv, SparseGraphAttention, SparseGraphConv
from .unimp import UniMP

__all__ = ["config", "layers", "model", "moe", "ssm", "transformer", "unimp",
           "ModelConfig", "GraphTransformerConv", "SparseGraphAttention",
           "SparseGraphConv", "UniMP"]
