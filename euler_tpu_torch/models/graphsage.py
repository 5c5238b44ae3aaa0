"""GraphSAGE, supervised (counterpart: euler_tpu/models/graphsage.py:24-85).

Serving runs `embed` and the `out` head; the loss and metric come with
training. Module names follow the flax tree (`net.gnn.convs.<i>`, `out`)
so `params.from_flax` maps one onto the other path by path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.nn.base_gnn import GNNNet


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

    def forward(self, batch: MiniBatch) -> tuple[torch.Tensor, torch.Tensor]:
        """(embeddings, logits)."""
        emb = self.embed(batch)
        return emb, self.out(emb)
