"""Shallow embedding models: DeepWalk / node2vec / LINE
(counterpart: euler_tpu/models/embedding_models.py).

Target and context embedding tables trained with the sampled-softmax
negative-sampling loss. The walks and pairs are drawn on the host
(`deepwalk_batches`, `line_batches`) or on the device (`DeviceWalkFlow`,
`DeviceEdgeFlow`); the step is table lookups and batched dot products.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.dataflow.walk import gen_pair
from euler_tpu_torch.nn.encoders import Embedding
from euler_tpu_torch.nn.heads import softmax_xent_col0
from euler_tpu_torch.nn.metrics import mrr


class SkipGramModel(nn.Module):
    """Target/context tables + sampled softmax (DeepWalk & LINE-2nd).

    Batch: dict(src int32[B], pos int32[B], negs int32[B, N], mask bool[B]).
    The loss is the masked mean, divided by max(sum(mask), 1).
    """

    def __init__(self, num_nodes: int, dim: int = 128, shared_context: bool = False):
        super().__init__()
        self.num_nodes = int(num_nodes)
        self.dim = int(dim)
        self.shared_context = shared_context  # True → LINE first-order (one table)
        self.target = Embedding(self.num_nodes + 1, self.dim)
        if not shared_context:
            self.ctx_table = Embedding(self.num_nodes + 1, self.dim)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.target(ids)

    def _ctx(self, ids):
        return self.target(ids) if self.shared_context else self.ctx_table(ids)

    def forward(self, batch: dict):
        src, pos, negs = batch["src"], batch["pos"], batch["negs"]
        mask = batch["mask"].float()
        e_src = self.target(src)  # [B, D]
        e_pos = self._ctx(pos)  # [B, D]
        e_neg = self._ctx(negs)  # [B, N, D]
        pos_logit = torch.sum(e_src * e_pos, dim=-1)
        neg_logit = torch.einsum("bd,bnd->bn", e_src, e_neg)
        logits = torch.cat([pos_logit[:, None], neg_logit], dim=1)
        per = softmax_xent_col0(logits)
        loss = torch.sum(per * mask) / torch.clamp_min(torch.sum(mask), 1.0)
        return e_src, loss, "mrr", mrr(pos_logit, neg_logit)


def _to32(x: np.ndarray) -> np.ndarray:
    """u64 ids → int32 (the JAX package's truncation; DEFAULT_ID → -1)."""
    return x.astype(np.int64).astype(np.int32)


def deepwalk_batches(
    graph,
    batch_size: int,
    walk_len: int = 5,
    window: int = 2,
    num_negs: int = 5,
    edge_types=None,
    p: float = 1.0,
    q: float = 1.0,
    node_type: int = -1,
    rng=None,
):
    """Walk → skip-gram pairs → (src, pos, negs, mask) batch source;
    p/q != 1 gives node2vec-biased walks."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        roots = graph.sample_node(batch_size, node_type, rng=rng)
        walks = graph.random_walk(roots, edge_types, walk_len=walk_len, p=p, q=q, rng=rng)
        pairs, mask = gen_pair(walks, window, window)
        negs = graph.sample_node(len(pairs) * num_negs, node_type, rng=rng)
        return (
            {
                "src": _to32(pairs[:, 0]),
                "pos": _to32(pairs[:, 1]),
                "negs": _to32(negs).reshape(len(pairs), num_negs),
                "mask": mask,
            },
        )

    return fn


def line_batches(graph, batch_size: int, num_negs: int = 5, edge_type: int = -1, rng=None):
    """Edge-sampling batch source for LINE."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        edges = graph.sample_edge(batch_size, edge_type, rng=rng)
        negs = graph.sample_node(batch_size * num_negs, -1, rng=rng)
        return (
            {
                "src": _to32(edges[:, 0]),
                "pos": _to32(edges[:, 1]),
                "negs": _to32(negs).reshape(batch_size, num_negs),
                "mask": np.ones(batch_size, dtype=bool),
            },
        )

    return fn
