"""Layer-wise (LADIES / FastGCN) dataflow
(counterpart: euler_tpu/dataflow/layerwise.py).

Each layer is one fixed-size candidate set shared by the whole batch,
drawn by `Graph.sample_neighbor_layerwise`, and the adjacency between
two layers is a dense [n_l, n_{l+1}] weight matrix, so a layer's
aggregation is one matrix product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import DataFlow
from euler_tpu_torch.graph.store import DEFAULT_ID


@dataclasses.dataclass
class LayerwiseBatch:
    """Dense-adjacency multi-layer batch.

    feats[l]  — f32[N_l, F] features of layer l (layer 0 = roots)
    masks[l]  — bool[N_l]
    adjs[l]   — f32[N_l, N_{l+1}] weighted adjacency layer l <- l+1
    root_idx  — int32[B] root ids
    labels    — optional f32[B, L]
    hop_ids   — optional int32 per-layer node ids (moved with the rest)
    """

    feats: tuple
    masks: tuple
    adjs: tuple
    root_idx: np.ndarray | torch.Tensor
    labels: np.ndarray | torch.Tensor | None = None
    hop_ids: tuple | None = None


class LayerwiseDataFlow(DataFlow):
    """LADIES-style: candidates drawn in proportion to their incident
    weight from the batch; with normalize=True each adjacency row sums to
    one."""

    def __init__(
        self,
        graph,
        feature_names,
        edge_types=None,
        layer_sizes=(128, 128),
        label_feature=None,
        label_dim=None,
        normalize: bool = True,
        rng=None,
        feature_mode="dense",
    ):
        super().__init__(graph, feature_names, label_feature, label_dim, rng, feature_mode)
        self.edge_types = edge_types
        self.layer_sizes = list(layer_sizes)
        self.normalize = normalize

    def query(self, roots: np.ndarray) -> LayerwiseBatch:
        roots = np.asarray(roots, dtype=np.uint64)
        layer_ids = [roots]
        layer_masks = [roots != DEFAULT_ID]
        adjs = []
        cur = roots
        for count in self.layer_sizes:
            layer, adj, lmask = self.graph.sample_neighbor_layerwise(
                cur, self.edge_types, count=count, rng=self.rng)
            if self.normalize:
                row = adj.sum(axis=1, keepdims=True)
                adj = adj / np.maximum(row, 1e-9)
            adjs.append(adj.astype(np.float32))
            layer_ids.append(layer)
            layer_masks.append(lmask)
            cur = layer
        return LayerwiseBatch(
            feats=tuple(self.node_feats(ids) for ids in layer_ids),
            masks=tuple(layer_masks),
            adjs=tuple(adjs),
            root_idx=roots.astype(np.int64).astype(np.int32),
            labels=self.labels_of(roots),
            hop_ids=tuple(ids.astype(np.int64).astype(np.int32) for ids in layer_ids),
        )
