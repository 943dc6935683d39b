"""UniMP: the Unified Message Passing model of Shi et al., "Masked Label
Prediction: Unified Message Passing Model for Semi-Supervised
Classification" (IJCAI 2021, arXiv:2009.03509), as PyTorch Geometric's
``examples/unimp_arxiv.py`` builds it, on the port's graph layers.

- The input carries the masked label embedding (PyG's ``MaskLabel``,
  method ``add``): ``x_i + E[label_i]`` at the nodes whose labels are
  given.
- ``num_layers`` :class:`~repro_torch.models.layers.GraphTransformerConv`
  layers with a root weight and the β gate: every layer but the last with
  ``heads`` heads of ``hidden // heads`` concatenated, the last with
  ``heads`` heads of ``classes`` averaged.
- Between layers ``LayerNorm`` and then ReLU.  Dropout is left out: the
  model here runs inference.

Every attention runs on the one prepared graph A, so it attends over A's
nonzeros: with a normalised A + I, over each node's neighbours and
itself.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .layers import GraphTransformerConv, _graph


class UniMP(nn.Module):
    """UniMP over graph ``a``: ``label_emb`` an ``nn.Embedding`` (classes,
    d_in), ``convs`` the layers, ``norms`` a ``LayerNorm`` after each but
    the last.  ``forward(x, labels, known)`` gives the logits (M,
    classes); ``labels`` (M,) int64 and ``known`` (L,) int64, the nodes
    whose labels the embedding adds."""

    def __init__(self, label_emb: nn.Embedding,
                 convs: List[GraphTransformerConv], norms: List[nn.LayerNorm]):
        super().__init__()
        if len(norms) != len(convs) - 1:
            raise ValueError(f"{len(convs)} layers take {len(convs) - 1} "
                             f"norms, got {len(norms)}")
        self.label_emb = label_emb
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    @classmethod
    def init(cls, a, d_in: int, hidden: int, classes: int, num_layers: int,
             heads: int, generator: Optional[torch.Generator] = None
             ) -> "UniMP":
        """Weights drawn as PyTorch Geometric initialises the model: the
        embedding standard normal, the layers' ``Linear`` weights uniform,
        the norms' weight one and bias zero."""
        a = _graph(a)
        dev = a.device
        emb = nn.Embedding(classes, d_in, device=dev)
        with torch.no_grad():
            emb.weight.copy_(torch.randn((classes, d_in), generator=generator,
                                         device=dev))
        convs, norms = [], []
        for layer in range(num_layers):
            last = layer == num_layers - 1
            convs.append(GraphTransformerConv.init(
                a, d_in if layer == 0 else hidden,
                classes if last else hidden // heads, heads, concat=not last,
                generator=generator))
            if not last:
                norms.append(nn.LayerNorm(hidden, device=dev))
        return cls(emb, convs, norms)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                known: torch.Tensor) -> torch.Tensor:
        x = x.index_add(0, known, self.label_emb(labels[known]))
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x)))
        return self.convs[-1](x)
