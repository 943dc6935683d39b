"""Model layers on the port's sparse operators."""
from .layers import SparseGraphAttention, SparseGraphConv

__all__ = ["SparseGraphAttention", "SparseGraphConv"]
