"""GraphSAGE, supervised and unsupervised
(counterpart: euler_tpu/models/graphsage.py:24-122), with the optional
ShallowEncoder input stage (id embedding + dense projection).

Training calls the model: (emb, loss, "f1", micro_f1), the loss being the
mean over rows of the summed sigmoid cross-entropy, as optax's. Serving
runs `embed` and the `out` head. Module names follow the flax tree
(`net.gnn.convs.<i>`, `net.encoder`, `out`) so `params.from_flax` maps one onto the
other path by path.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.nn.base_gnn import GNNNet
from euler_tpu_torch.nn.encoders import ShallowEncoder
from euler_tpu_torch.nn.heads import check_conv, contrastive_loss, sigmoid_binary_cross_entropy
from euler_tpu_torch.nn.metrics import micro_f1


class _EncodedGNN(nn.Module):
    """The ShallowEncoder stage applied to each hop, then the conv stack
    (counterpart: euler_tpu/models/graphsage.py:24-52). encoder_dim = 0
    runs the convs on the raw features; otherwise one
    `ShallowEncoder(dim=encoder_dim, max_id=max_id)` encodes every hop:
    its id embedding over `batch.hop_ids[h]` when max_id is set (pad rows
    carry id -1 and read row 0, and their masks keep them out of the
    aggregation), plus the projection of `batch.feats[h]`; the convs then
    take encoder_dim-wide inputs."""

    def __init__(self, in_dim: int, conv: str, dims: Sequence[int], encoder_dim: int = 0,
                 max_id: int = 0, conv_kwargs: dict | None = None, remat: bool = False):
        super().__init__()
        self.encoder_dim = int(encoder_dim)
        self.max_id = int(max_id)
        if self.encoder_dim:
            self.encoder = ShallowEncoder(in_dim, self.encoder_dim, max_id=self.max_id)
        self.gnn = GNNNet(in_dim=self.encoder_dim or in_dim, conv=conv, dims=dims,
                          conv_kwargs=conv_kwargs, remat=remat)

    def forward(self, batch: MiniBatch) -> torch.Tensor:
        if not self.encoder_dim:
            return self.gnn(batch)
        ids = batch.hop_ids or (None,) * len(batch.feats)
        feats = tuple(self.encoder(ids=i if self.max_id else None, dense=f)
                      for i, f in zip(ids, batch.feats))
        return self.gnn(dataclasses.replace(batch, feats=feats))


class GraphSAGESupervised(nn.Module):
    """conv_kwargs: passed to every conv ({"dtype": torch.bfloat16} runs the
    convs' linears in bf16; the `out` head stays f32, as flax's). remat:
    recompute each conv call's activations in the backward pass.
    encoder_dim > 0 puts the ShallowEncoder stage before the convs, with
    an id embedding of max_id + 1 rows when max_id > 0 (`_EncodedGNN`;
    the batches must carry hop_ids: `DeviceSageFlow(with_hop_ids=True)`
    or a non-lean host flow)."""

    def __init__(
        self,
        in_dim: int,
        dims: Sequence[int],
        label_dim: int,
        encoder_dim: int = 0,
        max_id: int = 0,
        conv: str = "sage",
        conv_kwargs: dict | None = None,
        remat: bool = False,
    ):
        super().__init__()
        self.net = _EncodedGNN(in_dim=in_dim, conv=conv, dims=dims, encoder_dim=encoder_dim,
                               max_id=max_id, conv_kwargs=conv_kwargs, remat=remat)
        self.out = nn.Linear(self.net.gnn.out_dim, label_dim)

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        return self.net(batch)

    def forward(self, batch: MiniBatch):
        """(embeddings, loss, "f1", micro-F1) over batch.labels."""
        emb = self.embed(batch)
        logits = self.out(emb.float())  # flax promotes bf16 embeddings to f32
        labels = batch.labels.float()
        loss = sigmoid_binary_cross_entropy(logits, labels).sum(dim=-1).mean()
        return emb, loss, "f1", micro_f1(labels, logits)


class GraphSAGEUnsupervised(nn.Module):
    """(src, pos, negs) contrastive GraphSAGE: one shared encoder embeds
    the three MiniBatches; the loss is the sampled-softmax cross-entropy
    with the positive in column 0, the metric MRR. remat, encoder_dim and
    max_id as the supervised model's."""

    def __init__(
        self,
        in_dim: int,
        dims: Sequence[int],
        encoder_dim: int = 0,
        max_id: int = 0,
        conv: str = "sage",
        conv_kwargs: dict | None = None,
        remat: bool = False,
    ):
        super().__init__()
        check_conv(conv)
        self.net = _EncodedGNN(in_dim=in_dim, conv=conv, dims=dims, encoder_dim=encoder_dim,
                               max_id=max_id, conv_kwargs=conv_kwargs, remat=remat)

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        return self.net(batch)

    def forward(self, src: MiniBatch, pos: MiniBatch, negs: MiniBatch):
        e_src = self.embed(src)
        loss, metric = contrastive_loss(
            e_src, self.embed(pos), self.embed(negs)
        )
        return e_src, loss, "mrr", metric
