"""Per-relation dataflow for RGCN (counterpart:
euler_tpu/dataflow/relation.py): each hop carries one Block per edge
type, so each relation keeps its own transform."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import Block, DataFlow
from euler_tpu_torch.graph.store import DEFAULT_ID


@dataclasses.dataclass
class RelMiniBatch:
    """feats[i] f32[N_i, F] and masks[i] bool[N_i] per hop; rel_blocks[i]
    one Block per relation from hop i+1 into hop i; hop_ids int32 per
    hop (moved to the device with the rest)."""

    feats: tuple
    masks: tuple
    rel_blocks: tuple
    root_idx: np.ndarray | torch.Tensor
    labels: np.ndarray | torch.Tensor | None = None
    hop_ids: tuple | None = None


def relation_src_slots(n: int, num_relations: int, fanout: int, rel: int) -> np.ndarray:
    """The src rows of relation `rel`'s edges: hop i+1 holds num_relations
    * fanout slots a node of hop i ([n, R, k] flattened), relation r's at
    [i*R*k + r*k + j]."""
    k = fanout
    return (np.arange(n)[:, None] * num_relations * k + rel * k
            + np.arange(k)[None, :]).reshape(-1).astype(np.int32)


class RelationDataFlow(DataFlow):
    """A fixed fanout per relation at every hop."""

    def __init__(
        self,
        graph,
        feature_names,
        num_relations: int,
        fanout: int = 5,
        num_hops: int = 2,
        label_feature=None,
        label_dim=None,
        rng=None,
    ):
        super().__init__(graph, feature_names, label_feature, label_dim, rng)
        self.num_relations = num_relations
        self.fanout = fanout
        self.num_hops = num_hops

    def query(self, roots: np.ndarray) -> RelMiniBatch:
        roots = np.asarray(roots, dtype=np.uint64)
        hop_ids = [roots]
        hop_masks = [roots != DEFAULT_ID]
        rel_blocks = []
        cur = roots
        k, nr = self.fanout, self.num_relations
        for _ in range(self.num_hops):
            n = len(cur)
            nxt = np.full((n, nr, k), DEFAULT_ID, dtype=np.uint64)
            blocks = []
            for r in range(nr):
                nbr, w, _, mask, _ = self.graph.sample_neighbor(cur, [r], k, rng=self.rng)
                nxt[:, r, :] = nbr
                blocks.append(Block(
                    edge_src=relation_src_slots(n, nr, k, r),
                    edge_dst=np.repeat(np.arange(n, dtype=np.int32), k),
                    edge_w=w.reshape(-1).astype(np.float32),
                    mask=mask.reshape(-1),
                    n_src=n * nr * k,
                    n_dst=n,
                ))
            rel_blocks.append(tuple(blocks))
            cur = nxt.reshape(-1)
            hop_ids.append(cur)
            hop_masks.append(cur != DEFAULT_ID)
        return RelMiniBatch(
            feats=tuple(self.node_feats(ids) for ids in hop_ids),
            masks=tuple(hop_masks),
            rel_blocks=tuple(rel_blocks),
            root_idx=roots.astype(np.int64).astype(np.int32),
            labels=self.labels_of(roots),
            hop_ids=tuple(ids.astype(np.int64).astype(np.int32) for ids in hop_ids),
        )
