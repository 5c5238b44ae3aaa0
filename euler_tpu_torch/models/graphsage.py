"""GraphSAGE, supervised and unsupervised
(counterpart: euler_tpu/models/graphsage.py:24-122).

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

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.nn.base_gnn import GNNNet
from euler_tpu_torch.nn.heads import check_conv, contrastive_loss, sigmoid_binary_cross_entropy
from euler_tpu_torch.nn.metrics import micro_f1


class _EncodedGNN(nn.Module):
    """The conv stack over raw features (no ShallowEncoder stage yet)."""

    def __init__(self, in_dim: int, conv: str, dims: Sequence[int],
                 conv_kwargs: dict | None = None, remat: bool = False):
        super().__init__()
        self.gnn = GNNNet(in_dim=in_dim, conv=conv, dims=dims, conv_kwargs=conv_kwargs,
                          remat=remat)

    def forward(self, batch: MiniBatch) -> torch.Tensor:
        return self.gnn(batch)


class GraphSAGESupervised(nn.Module):
    """conv_kwargs: passed to every conv ({"dtype": torch.bfloat16} runs the
    convs' linears in bf16; the `out` head stays f32, as flax's). remat:
    recompute each conv call's activations in the backward pass.
    `encoder_dim`/`max_id` (the ShallowEncoder stage) are not ported yet
    (ROADMAP queue 1 item 4)."""

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
        if encoder_dim or max_id:
            raise NotImplementedError(
                "GraphSAGESupervised(encoder_dim=, max_id=) needs ShallowEncoder, "
                "which is not ported yet (ROADMAP queue 1 item 4)"
            )
        self.net = _EncodedGNN(in_dim=in_dim, conv=conv, dims=dims, conv_kwargs=conv_kwargs,
                               remat=remat)
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
    with the positive in column 0, the metric MRR. remat as the supervised
    model's; `encoder_dim`/`max_id` (the ShallowEncoder stage) are not
    ported yet."""

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
        if encoder_dim or max_id:
            raise NotImplementedError(
                "GraphSAGEUnsupervised(encoder_dim=, max_id=) needs ShallowEncoder, "
                "which is not ported yet (ROADMAP queue 1 item 4)"
            )
        check_conv(conv)
        self.net = _EncodedGNN(in_dim=in_dim, conv=conv, dims=dims, conv_kwargs=conv_kwargs,
                               remat=remat)

    def embed(self, batch: MiniBatch) -> torch.Tensor:
        return self.net(batch)

    def forward(self, src: MiniBatch, pos: MiniBatch, negs: MiniBatch):
        e_src = self.embed(src)
        loss, metric = contrastive_loss(
            e_src, self.embed(pos), self.embed(negs)
        )
        return e_src, loss, "mrr", metric
