"""Scalable (history-embedding) GCN / SAGE training
(counterpart: euler_tpu/models/scalable.py:25-164).

Each layer keeps a host-side `HistoryTable` of its last activations; a
train step touches only the roots and their 1-hop neighbours, reads the
deeper context from the tables and refreshes the roots' rows with a
moving average. The receptive field of a step is one hop whatever the
depth. The masked mean and the Linears are plain torch: the JAX package
leaves them to XLA, and no kernel of the port runs here.

The Linears keep flax's names (`layers_<i>`, `self_layers_<i>` without
bias, `out`), so `params.from_flax` and `params.flax_init` map them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.nn.heads import sigmoid_binary_cross_entropy
from euler_tpu_torch.nn.history import HistoryTable
from euler_tpu_torch.nn.metrics import micro_f1


class ScalableGNN(nn.Module):
    """K stacked mean-aggregator layers over history inputs:
    h = relu(Linear(masked mean of nbr_hist[l]) + Linear_no_bias(h)), no
    relu after the last layer.

    Batch dict: feats f32[B, in_dim]; nbr_hist a tuple of f32[B, k, D_l]
    (layer l's neighbour activations from history; l = 0 the raw
    neighbour features, D_0 = in_dim, D_l = dims[l - 1]); nbr_mask
    bool[B, k]; labels f32[B, label_dim].
    """

    def __init__(self, in_dim: int, dims: Sequence[int], label_dim: int):
        super().__init__()
        self.dims = [int(d) for d in dims]
        width = int(in_dim)
        for i, d in enumerate(self.dims):
            self.add_module(f"layers_{i}", nn.Linear(width, d))
            self.add_module(f"self_layers_{i}", nn.Linear(width, d, bias=False))
            width = d
        self.out = nn.Linear(width, label_dim)

    def activations(self, batch) -> list[torch.Tensor]:
        h = batch["feats"]
        m = batch["nbr_mask"].float()[..., None]
        count = m.sum(dim=1).clamp_min(1.0)
        acts = []
        for i in range(len(self.dims)):
            agg = (batch["nbr_hist"][i] * m).sum(dim=1) / count
            h = getattr(self, f"layers_{i}")(agg) + getattr(self, f"self_layers_{i}")(h)
            if i < len(self.dims) - 1:
                h = torch.relu(h)
            acts.append(h)
        return acts

    def embed(self, batch) -> torch.Tensor:
        return self.activations(batch)[-1]

    def forward(self, batch):
        """(every layer's activations, loss, "f1", micro-F1)."""
        acts = self.activations(batch)
        logits = self.out(acts[-1])
        labels = batch["labels"].float()
        loss = sigmoid_binary_cross_entropy(logits, labels).sum(dim=-1).mean()
        return acts, loss, "f1", micro_f1(labels, logits)


class ScalableTrainer:
    """The 1-hop train loop with history fetch / update around one eager
    step (forward, loss, adam update). Batches are drawn on the host from
    the caller's numpy `rng` in the JAX package's order (`sample_node`,
    `sample_neighbor`, then the features), so one rng gives one batch
    stream in both packages. The first batch initialises the params as
    JAX's `model.init(PRNGKey(0), batch)` does (`params.flax_init(model,
    0, raw_key=True)`), unless the caller set `params` (a state_dict)
    first. On the CUDA card unless device="cpu"."""

    def __init__(
        self,
        graph,
        model: ScalableGNN,
        feature_names,
        max_id: int,
        batch_size: int = 64,
        fanout: int = 10,
        edge_types=None,
        label_feature: str = "label",
        learning_rate: float = 0.01,
        momentum: float = 0.9,
        rng=None,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.model = model
        self.feature_names = feature_names
        self.batch_size = batch_size
        self.fanout = fanout
        self.edge_types = edge_types
        self.label_feature = label_feature
        self.learning_rate = learning_rate
        self.rng = rng if rng is not None else np.random.default_rng()
        feat_dim = graph.get_dense_feature(np.asarray([1], np.uint64), feature_names).shape[1]
        self.feat_dim = feat_dim
        self.histories = [HistoryTable(max_id, d, momentum)
                          for d in [feat_dim] + list(model.dims[:-1])]
        self.params = None
        self.optimizer = None

    def _make_batch(self):
        """(roots, the numpy batch dict) of one step."""
        g = self.graph
        roots = g.sample_node(self.batch_size, -1, rng=self.rng)
        nbr, _, _, mask, _ = g.sample_neighbor(roots, self.edge_types, self.fanout, rng=self.rng)
        flat = nbr.reshape(-1)
        nbr_hist = []
        for li, h in enumerate(self.histories):
            vals = g.get_dense_feature(flat, self.feature_names) if li == 0 else h.fetch(flat)
            nbr_hist.append(vals.reshape(self.batch_size, self.fanout, -1).astype(np.float32))
        return roots, {
            "feats": g.get_dense_feature(roots, self.feature_names),
            "nbr_hist": tuple(nbr_hist),
            "nbr_mask": mask,
            "labels": g.get_dense_feature(roots, [self.label_feature]),
        }

    def _init(self) -> None:
        from euler_tpu_torch.params import flax_init

        if self.params is None:
            self.params = flax_init(self.model, 0, raw_key=True)
        self.model.load_state_dict(self.params)
        self.model.to(self.device)
        self.params = self.model.state_dict()  # the live tensors from now on
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.learning_rate)

    def step(self, batch) -> tuple[float, list[np.ndarray]]:
        """One optimizer step on a numpy batch dict: (loss, every layer's
        pre-update activations on the host)."""
        if self.optimizer is None:
            self._init()

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        tb = {"feats": put(batch["feats"]), "nbr_hist": tuple(put(a) for a in batch["nbr_hist"]),
              "nbr_mask": put(batch["nbr_mask"]), "labels": put(batch["labels"])}
        self.optimizer.zero_grad(set_to_none=True)
        acts, loss, _, _ = self.model(tb)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach()), [a.detach().cpu().numpy() for a in acts]

    def train(self, steps: int) -> list[float]:
        history = []
        for _ in range(steps):
            roots, batch = self._make_batch()
            loss, acts = self.step(batch)
            # refresh histories: layer l+1's input table holds layer l's output
            for li in range(1, len(self.histories)):
                self.histories[li].update(roots, acts[li - 1])
            history.append(loss)
        return history
