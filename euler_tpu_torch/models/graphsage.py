"""GraphSAGE, supervised (counterpart: euler_tpu/models/graphsage.py:24-85).

Training calls the model: (emb, loss, "f1", micro_f1), the loss being the
mean over rows of the summed sigmoid cross-entropy, as optax's. Serving
runs `embed` and the `out` head. Module names follow the flax tree
(`net.gnn.convs.<i>`, `out`) so `params.from_flax` maps one onto the
other path by path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from torch.nn import functional as F

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.nn.base_gnn import GNNNet
from euler_tpu_torch.nn.metrics import micro_f1


class _EncodedGNN(nn.Module):
    """The conv stack over raw features (no ShallowEncoder stage yet)."""

    def __init__(self, conv: str, in_dim: int, dims: Sequence[int]):
        super().__init__()
        self.gnn = GNNNet(conv=conv, in_dim=in_dim, dims=dims)

    def forward(self, batch: MiniBatch) -> torch.Tensor:
        return self.gnn(batch)


class GraphSAGESupervised(nn.Module):
    def __init__(
        self, in_dim: int, dims: Sequence[int], label_dim: int, conv: str = "sage"
    ):
        super().__init__()
        self.net = _EncodedGNN(conv=conv, in_dim=in_dim, dims=dims)
        self.out = nn.Linear(list(dims)[-1], label_dim)

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        return self.net(batch)

    def forward(self, batch: MiniBatch):
        """(embeddings, loss, "f1", micro-F1) over batch.labels."""
        emb = self.embed(batch)
        logits = self.out(emb)
        labels = batch.labels.float()
        loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        loss = loss.sum(dim=-1).mean()
        return emb, loss, "f1", micro_f1(labels, logits)
