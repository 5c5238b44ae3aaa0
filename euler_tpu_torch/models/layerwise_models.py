"""Layer-wise GCN for FastGCN / AdaptiveGCN over dense per-layer
adjacencies (counterpart: euler_tpu/models/layerwise_models.py): a
layer's aggregation is one dense [n_l, n_{l+1}] product, `torch.matmul`
as the JAX package computes it outside any kernel.

The Linears keep flax's names: `denses_<l>`, `self_denses_<l>` (no
bias) and `out`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from euler_tpu_torch.dataflow.layerwise import LayerwiseBatch
from euler_tpu_torch.nn.heads import sigmoid_binary_cross_entropy
from euler_tpu_torch.nn.metrics import micro_f1


class LayerwiseGCN(nn.Module):
    """h_l = act(A_l · h_{l+1} · W_l + h_l · S_l), from the deepest layer
    up; the last layer has no activation."""

    def __init__(self, in_dim: int, dims: Sequence[int], label_dim: int,
                 activation: str = "relu"):
        super().__init__()
        self.dims = list(dims)
        width = in_dim
        for i, d in enumerate(self.dims):
            self.add_module(f"denses_{i}", nn.Linear(width, d))
            self.add_module(f"self_denses_{i}", nn.Linear(width, d, bias=False))
            width = d
        self.out = nn.Linear(width, label_dim)
        self.activation = activation

    def embed(self, batch: LayerwiseBatch) -> torch.Tensor:
        act = getattr(F, self.activation)
        num_layers = len(batch.adjs)
        if len(self.dims) != num_layers:
            raise ValueError(f"dims {self.dims} must match the batch's {num_layers} layers")
        xs = list(batch.feats)
        for layer in range(num_layers):
            dense = getattr(self, f"denses_{layer}")
            self_dense = getattr(self, f"self_denses_{layer}")
            last = layer == num_layers - 1
            new_xs = []
            for lv in range(num_layers - layer):
                h = dense(torch.matmul(batch.adjs[lv], xs[lv + 1])) + self_dense(xs[lv])
                if not last:
                    h = act(h)
                h = h * batch.masks[lv][: h.shape[0], None].to(h.dtype)
                new_xs.append(h)
            xs = new_xs
        return xs[0]

    def forward(self, batch: LayerwiseBatch):
        emb = self.embed(batch)
        logits = self.out(emb)
        labels = batch.labels.float()
        loss = sigmoid_binary_cross_entropy(logits, labels).sum(dim=-1).mean()
        return emb, loss, "f1", micro_f1(labels, logits)
