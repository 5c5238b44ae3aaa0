"""Graph auto-encoders and the contrastive DGI (counterpart:
euler_tpu/models/autoencoders.py): GAE and VGAE (`variational=True`),
DGI, and their host batch sources `gae_batches` and `dgi_batches`.

VGAE's reparameterisation noise is a random stream the model declares
(`rng_collections`, as in the JAX package). The Estimator draws it
outside the step with `draw_rngs` and passes it in as `rngs=`, so a
captured step replays with new noise and a test can feed JAX's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.layers.conv import lecun_normal_
from euler_tpu_torch.nn.base_gnn import GNNNet
from euler_tpu_torch.nn.heads import sigmoid_binary_cross_entropy
from euler_tpu_torch.nn.metrics import auc


def _bce_auc(logits: torch.Tensor, labels: torch.Tensor):
    loss = sigmoid_binary_cross_entropy(logits, labels).mean()
    return loss, auc(labels, logits)


class GAE(nn.Module):
    """A GCN encoder and an inner-product edge decoder. The batch is
    (src, dst, neg): positive edges src -> dst against sampled pairs src
    -> neg. variational=True adds the `mu_head` / `logvar_head` Linears
    and the KL term (VGAE)."""

    rng_collections = ("reparam",)

    def __init__(self, in_dim: int, dims: Sequence[int], variational: bool = False,
                 kl_weight: float = 1e-2, remat: bool = False):
        super().__init__()
        self.variational = variational
        self.kl_weight = kl_weight
        self.encoder = GNNNet(in_dim, "gcn", dims, remat=remat)
        width = self.encoder.out_dim
        if variational:
            self.mu_head = nn.Linear(width, dims[-1])
            self.logvar_head = nn.Linear(width, dims[-1])
        self.dim = dims[-1]

    def draw_rngs(self, generator: torch.Generator, rows: int, device) -> dict:
        """The step's draws of the model's random streams: VGAE's
        "reparam" noise, standard normals [3, rows, dim] (src, dst, neg);
        none for GAE."""
        if not self.variational:
            return {}
        return {"reparam": torch.randn((3, rows, self.dim), generator=generator,
                                       device=device)}

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        h = self.encoder(batch)
        return self.mu_head(h) if self.variational else h

    def _encode(self, batch: MiniBatch, eps):
        h = self.encoder(batch)
        if not self.variational:
            return h, 0.0
        mu = self.mu_head(h)
        logvar = self.logvar_head(h)
        z = mu + torch.exp(0.5 * logvar) * eps
        kl = -0.5 * torch.mean(torch.sum(1 + logvar - mu**2 - torch.exp(logvar), dim=-1))
        return z, kl

    def forward(self, src: MiniBatch, dst: MiniBatch, neg: MiniBatch, rngs: dict | None = None):
        eps = (None, None, None)
        if self.variational:
            if not rngs or "reparam" not in rngs:
                raise ValueError("a variational GAE needs rngs={'reparam': noise} (draw_rngs)")
            eps = rngs["reparam"]
        z_src, kl1 = self._encode(src, eps[0])
        z_dst, kl2 = self._encode(dst, eps[1])
        z_neg, kl3 = self._encode(neg, eps[2])
        pos_logit = torch.sum(z_src * z_dst, dim=-1)
        neg_logit = torch.sum(z_src * z_neg, dim=-1)
        logits = torch.cat([pos_logit, neg_logit])
        labels = torch.cat([torch.ones_like(pos_logit), torch.zeros_like(neg_logit)])
        loss, metric = _bce_auc(logits, labels)
        if self.variational:
            loss = loss + self.kl_weight * (kl1 + kl2 + kl3) / 3.0
        return z_src, loss, "auc", metric


class DGI(nn.Module):
    """Deep Graph Infomax: the real batch against its feature-shuffled
    copy, each scored against the real batch's readout through the
    bilinear discriminator `bilinear` [d, d]."""

    def __init__(self, in_dim: int, dims: Sequence[int], remat: bool = False):
        super().__init__()
        self.encoder = GNNNet(in_dim, "gcn", dims, remat=remat)
        d = dims[-1]
        self.bilinear = nn.Parameter(torch.empty(d, d))
        self.reset_like_flax()

    @torch.no_grad()
    def reset_like_flax(self, generator: torch.Generator | None = None) -> None:
        """flax's lecun_normal on the [d, d] discriminator."""
        lecun_normal_(self.bilinear, self.bilinear.shape[0], generator)

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        return self.encoder(batch)

    def forward(self, batch: MiniBatch, corrupt: MiniBatch):
        h_real = self.encoder(batch)
        h_fake = self.encoder(corrupt)
        summary = torch.sigmoid(torch.mean(h_real, dim=0))
        logits = torch.cat([h_real @ self.bilinear @ summary, h_fake @ self.bilinear @ summary])
        labels = torch.cat([torch.ones(h_real.shape[0], device=h_real.device),
                            torch.zeros(h_fake.shape[0], device=h_fake.device)])
        loss, metric = _bce_auc(logits, labels)
        return h_real, loss, "auc", metric


def gae_batches(graph, flow, batch_size: int, edge_type: int = -1, rng=None):
    """(src, dst, neg) source over sampled edges: a batch of edges and as
    many nodes, each through `flow.query`."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        e = graph.sample_edge(batch_size, edge_type, rng=rng)
        neg = graph.sample_node(batch_size, -1, rng=rng)
        return (flow.query(e[:, 0]), flow.query(e[:, 1]), flow.query(neg))

    return fn


def dgi_batches(graph, flow, batch_size: int, node_type: int = -1, rng=None):
    """(real, corrupted) source: the corruption permutes each hop's
    feature rows across the batch (DGI's standard corruption), one
    `rng.permutation` a hop."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        roots = graph.sample_node(batch_size, node_type, rng=rng)
        mb = flow.query(roots)
        perm_feats = tuple(f[rng.permutation(len(f))] for f in mb.feats)
        return (mb, dataclasses.replace(mb, feats=perm_feats))

    return fn
