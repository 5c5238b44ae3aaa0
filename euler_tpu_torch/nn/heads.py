"""Task heads: supervised and unsupervised (negative-sampling) models
(counterpart: euler_tpu/nn/heads.py:23-86).

A model call returns (embedding, loss, metric_name, metric), as in the
JAX package. `SuperviseModel` is sigmoid cross-entropy + micro-F1;
`UnsuperviseModel` embeds (src, pos, negs) with one shared GNN and
optimizes the sampled-softmax cross-entropy with the positive in column
0, reporting MRR. The convs of `layers.CONVS` are ported; the others wait
for ROADMAP queue 1 item 4. A whole-graph batch's `target_idx` picks the
rows that carry the loss and the metric.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.layers import CONVS
from euler_tpu_torch.nn.base_gnn import GNNNet
from euler_tpu_torch.nn.metrics import micro_f1, mrr


def check_conv(conv: str, remat: bool = False) -> None:
    """Refuse what the port's heads cannot run yet, naming its ROADMAP item."""
    if conv not in CONVS:
        raise NotImplementedError(
            f"conv {conv!r} is not ported yet (ROADMAP queue 1 item 4: the conv zoo's "
            f"second half); the port has {sorted(CONVS)}"
        )
    if remat:
        raise NotImplementedError("remat=True is not ported yet (ROADMAP queue 1 item 2)")


def softmax_xent_col0(logits: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels with every label 0,
    in optax's log-sum-exp form: logits shifted by their (constant) row
    max, log Σ exp minus the label's logit. [B, C] → [B]."""
    shifted = logits - logits.max(dim=-1, keepdim=True).values.detach()
    return torch.log(torch.sum(torch.exp(shifted), dim=-1)) - shifted[:, 0]


def contrastive_loss(e_src, e_pos, e_neg, temperature: float = 1.0):
    """(loss, MRR) of the (src, pos, negs) head: e_neg holds B*N rows,
    N negatives a source."""
    b, d = e_src.shape
    e_neg = e_neg.reshape(b, -1, d)
    pos_logit = torch.sum(e_src * e_pos, dim=-1) / temperature  # [B]
    neg_logit = torch.einsum("bd,bnd->bn", e_src, e_neg) / temperature  # [B, N]
    logits = torch.cat([pos_logit[:, None], neg_logit], dim=1)
    return softmax_xent_col0(logits).mean(), mrr(pos_logit, neg_logit)


class SuperviseModel(nn.Module):
    def __init__(
        self,
        in_dim: int,
        conv: str,
        dims: Sequence[int],
        label_dim: int,
        conv_kwargs: dict | None = None,
        remat: bool = False,
    ):
        super().__init__()
        check_conv(conv, remat)
        self.gnn = GNNNet(in_dim=in_dim, conv=conv, dims=dims, conv_kwargs=conv_kwargs)
        self.out = nn.Linear(self.gnn.out_dim, label_dim)

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        return self.gnn(batch)

    def forward(self, batch: MiniBatch):
        emb = self.embed(batch)
        if batch.target_idx is not None:
            # whole-graph flows: only the target rows carry loss and metric
            emb = emb[batch.target_idx.long()]
        logits = self.out(emb.float())
        labels = batch.labels.float()
        loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        loss = loss.sum(dim=-1).mean()
        return emb, loss, "f1", micro_f1(labels, logits)


class UnsuperviseModel(nn.Module):
    """src/pos/neg contrastive head over a shared GNN encoder."""

    def __init__(
        self,
        in_dim: int,
        conv: str,
        dims: Sequence[int],
        conv_kwargs: dict | None = None,
        temperature: float = 1.0,
        remat: bool = False,
    ):
        super().__init__()
        check_conv(conv, remat)
        self.gnn = GNNNet(in_dim=in_dim, conv=conv, dims=dims, conv_kwargs=conv_kwargs)
        self.temperature = temperature

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        return self.gnn(batch)

    def forward(self, src: MiniBatch, pos: MiniBatch, negs: MiniBatch):
        """negs hold B*N roots (N negatives per source)."""
        e_src = self.embed(src)
        loss, metric = contrastive_loss(
            e_src, self.embed(pos), self.embed(negs), self.temperature
        )
        return e_src, loss, "mrr", metric
