"""Neighbourhood aggregators over padded [B, K, F] grids
(counterpart: euler_tpu/nn/aggregators.py): mean / meanpool / maxpool /
gcn / attention, in plain torch.

Each takes (self_x [B, F], nbr [B, K, F], mask bool[B, K]) and returns
[B, dim]. The JAX package's signature is `Aggregator(dim)`; flax infers
the input width, which the port takes first, as `in_dim`. The
Linears keep flax's compact order: `Dense_0` is `linear`, `Dense_<j>`
`linear_<j>`, so `params.from_flax` maps them.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Aggregator(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.dim = int(dim)
        self.in_dim = int(in_dim)

    def masked(self, nbr, mask):
        return nbr * mask.to(nbr.dtype)[..., None]


def _masked_mean(x, mask):
    m = mask.float()[..., None]
    return torch.sum(x * m, dim=1) / m.sum(dim=1).clamp_min(1.0)


class MeanAggregator(Aggregator):
    def __init__(self, in_dim: int, dim: int):
        super().__init__(in_dim, dim)
        self.linear = nn.Linear(in_dim, dim)
        self.linear_1 = nn.Linear(in_dim, dim, bias=False)

    def forward(self, self_x, nbr, mask):
        return torch.relu(self.linear(self_x) + self.linear_1(_masked_mean(nbr, mask)))


class GCNAggregator(Aggregator):
    def __init__(self, in_dim: int, dim: int):
        super().__init__(in_dim, dim)
        self.linear = nn.Linear(in_dim, dim)

    def forward(self, self_x, nbr, mask):
        m = mask.float()[..., None]
        total = torch.sum(nbr * m, dim=1) + self_x
        return torch.relu(self.linear(total / (m.sum(dim=1) + 1.0)))


class MeanPoolAggregator(Aggregator):
    def __init__(self, in_dim: int, dim: int):
        super().__init__(in_dim, dim)
        self.linear = nn.Linear(in_dim, dim)
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim, bias=False)

    def forward(self, self_x, nbr, mask):
        pooled = _masked_mean(torch.relu(self.linear(nbr)), mask)
        return torch.relu(self.linear_1(self_x) + self.linear_2(pooled))


class MaxPoolAggregator(MeanPoolAggregator):
    def forward(self, self_x, nbr, mask):
        h = torch.relu(self.linear(nbr))
        neg = torch.finfo(h.dtype).min
        pooled = torch.where(mask[..., None], h, torch.full_like(h, neg)).amax(dim=1)
        pooled = torch.where(mask.any(dim=1)[:, None], pooled, torch.zeros_like(pooled))
        return torch.relu(self.linear_1(self_x) + self.linear_2(pooled))


class AttentionAggregator(Aggregator):
    def __init__(self, in_dim: int, dim: int):
        super().__init__(in_dim, dim)
        self.linear = nn.Linear(in_dim, dim)
        self.linear_1 = nn.Linear(in_dim, dim)

    def forward(self, self_x, nbr, mask):
        q = self.linear(self_x)  # [B, D]
        k = self.linear_1(nbr)  # [B, K, D]
        e = torch.einsum("bd,bkd->bk", q, k) / math.sqrt(float(self.dim))
        e = torch.where(mask, e, torch.full_like(e, torch.finfo(e.dtype).min))
        alpha = torch.softmax(e, dim=1)
        alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
        return torch.relu(q + torch.einsum("bk,bkd->bd", alpha, k))


AGGREGATORS = {
    "mean": MeanAggregator,
    "gcn": GCNAggregator,
    "meanpool": MeanPoolAggregator,
    "maxpool": MaxPoolAggregator,
    "attention": AttentionAggregator,
}


def get_aggregator(name: str):
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(AGGREGATORS)}")
    return AGGREGATORS[name]
