"""Whole-graph classification (counterpart: euler_tpu/models/graph_clf.py):
a conv stack over a GraphBatch's node table, a graph pooling, a softmax
head; the metric is accuracy.

flax names the members of the JAX model's `setup` lists `convs_<l>`, and
its pool and head `pooler` and `head`: the port's modules carry the same
names (`params.from_flax`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from euler_tpu_torch.dataflow.whole import GraphBatch
from euler_tpu_torch.layers import get_conv
from euler_tpu_torch.nn.base_gnn import call_layer
from euler_tpu_torch.nn.heads import check_conv, softmax_xent
from euler_tpu_torch.nn.metrics import accuracy
from euler_tpu_torch.nn.pooling import POOLS


class GraphClassifier(nn.Module):
    """in_dim: the node features' width; conv: a name of `layers.CONVS`;
    dims: each conv's width; pool: add | mean | max | attention | set2set;
    remat: recompute each conv's activations in the backward pass
    (`base_gnn.call_layer`)."""

    def __init__(
        self,
        in_dim: int,
        conv: str = "gin",
        dims: Sequence[int] = (32, 32),
        num_classes: int = 2,
        pool: str = "mean",
        activation: str = "relu",
        remat: bool = False,
    ):
        super().__init__()
        check_conv(conv)
        cls = get_conv(conv)
        convs, width = [], in_dim
        for d in dims:
            convs.append(cls(width, d))
            width = convs[-1].out_width
        self.convs = nn.ModuleList(convs)
        self.pooler = POOLS[pool](width)
        self.head = nn.Linear(self.pooler.out_width, num_classes)
        self.activation = activation
        self.remat = remat

    def embed(self, batch: GraphBatch) -> torch.Tensor:
        """[G, pooled width] graph embeddings: each conv over (x, x,
        block), the activation between convs, the node mask after each."""
        act = getattr(F, self.activation)
        x = batch.feats
        mask = batch.node_mask[:, None]
        for i, conv in enumerate(self.convs):
            x = call_layer(conv, self.remat, x, x, batch.block)
            if i < len(self.convs) - 1:
                x = act(x)
            x = x * mask.to(x.dtype)
        return self.pooler(x, batch.graph_ids, batch.n_graphs, mask=batch.node_mask)

    def forward(self, batch: GraphBatch):
        emb = self.embed(batch)
        logits = self.head(emb)
        labels = torch.argmax(batch.labels, dim=-1)
        loss = softmax_xent(logits, labels).mean()
        return emb, loss, "acc", accuracy(labels, torch.argmax(logits, dim=-1))
