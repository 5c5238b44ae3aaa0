"""RGCN over per-relation blocks (counterpart: euler_tpu/models/rgcn.py).

Training calls the model: (emb, loss, "f1", micro_f1), the loss the mean
over rows of the summed sigmoid cross-entropy. Module names follow the
flax tree (`convs_<i>` is `convs.<i>`, `out`), so `params.from_flax`
maps one onto the other path by path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from euler_tpu_torch.dataflow.relation import RelMiniBatch
from euler_tpu_torch.layers import RelationConv
from euler_tpu_torch.nn.heads import sigmoid_binary_cross_entropy
from euler_tpu_torch.nn.metrics import micro_f1


class RGCNSupervised(nn.Module):
    """A RelationConv a layer, shared by the hops it transforms; layer l
    turns hops [0, H-l) into their next embeddings, so after H layers hop
    0 holds the roots'."""

    def __init__(
        self,
        in_dim: int,
        dims: Sequence[int],
        num_relations: int,
        label_dim: int,
        num_bases: int = 0,
        activation: str = "relu",
    ):
        super().__init__()
        convs, width = [], in_dim
        for d in dims:
            convs.append(RelationConv(width, d, num_relations=num_relations,
                                      num_bases=num_bases))
            width = d
        self.convs = nn.ModuleList(convs)
        self.out = nn.Linear(width, label_dim)
        self.activation = activation

    def embed(self, batch: RelMiniBatch) -> torch.Tensor:
        act = getattr(F, self.activation)
        num_hops = len(batch.rel_blocks)
        xs = list(batch.feats)
        for layer in range(num_hops):
            conv = self.convs[layer]
            last = layer == num_hops - 1
            new_xs = []
            for hop in range(num_hops - layer):
                h = conv(xs[hop], xs[hop + 1], batch.rel_blocks[hop])
                if not last:
                    h = act(h)
                h = h * batch.masks[hop][: h.shape[0], None].to(h.dtype)
                new_xs.append(h)
            xs = new_xs
        return xs[0]

    def forward(self, batch: RelMiniBatch):
        emb = self.embed(batch)
        logits = self.out(emb)
        labels = batch.labels.float()
        loss = sigmoid_binary_cross_entropy(logits, labels).sum(dim=-1).mean()
        return emb, loss, "f1", micro_f1(labels, logits)
