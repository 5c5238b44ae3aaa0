"""The whole-graph flow of transductive node classification
(counterpart: euler_tpu/dataflow/whole.py:145-256, `FullGraphFlow`).

`WholeGraphDataFlow` and `graph_label_batches` (graph classification)
are not ported yet.
"""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.dataflow.base import Block, DataFlow, MiniBatch


class FullGraphFlow(DataFlow):
    """Full-batch node classification over the entire graph.

    One node table X[N, F] and one edge Block are built once and reused
    for all `num_hops` layers; `query(roots)` only picks which rows carry
    the loss (`target_idx`). With gcn_norm=True the block carries the true
    degrees, so GCNConv runs the exact D^-1/2 (A+I) D^-1/2 propagation.
    """

    def __init__(
        self,
        graph,
        feature_names,
        label_feature: str,
        num_hops: int = 2,
        edge_types=None,
        gcn_norm: bool = True,
        add_self_loops: bool = False,
        rng=None,
    ):
        """add_self_loops appends one unit-weight (i, i) edge a node, and
        turns gcn_norm off: GCNConv's normalization already holds the
        implicit self loop."""
        if add_self_loops:
            gcn_norm = False
        super().__init__(graph, feature_names, label_feature, rng=rng)
        self.num_hops = num_hops
        if not all(hasattr(s, "node_ids") for s in graph.shards):
            raise ValueError(
                "FullGraphFlow needs local shards (it reads the whole node"
                " and edge tables at construction); for remote graphs use a"
                " sampled flow or load the data locally"
            )
        # the sorted ids of every shard, one table row a node
        ids = np.sort(
            np.concatenate([np.asarray(s.node_ids) for s in graph.shards])
        ).astype(np.uint64)
        self.ids = ids
        self.X = self.node_feats(ids)
        self.Y = graph.get_dense_feature(ids, [label_feature])
        srcs, dsts, ws = [], [], []
        for s in graph.shards:
            keep = (
                np.isin(np.asarray(s.edge_types), list(edge_types))
                if edge_types is not None
                else slice(None)
            )
            srcs.append(np.asarray(s.edge_src)[keep])
            dsts.append(np.asarray(s.edge_dst)[keep])
            ws.append(np.asarray(s.edge_weights)[keep])
        n = len(ids)

        def rows_of(vals):  # id -> table row; a dangling id -> -1
            pos = np.clip(np.searchsorted(ids, vals), 0, n - 1)
            return np.where(ids[pos] == vals, pos, -1).astype(np.int32)

        src = rows_of(np.concatenate(srcs))
        dst = rows_of(np.concatenate(dsts))
        ok = (src >= 0) & (dst >= 0)  # drop edges with a dangling end
        src, dst = src[ok], dst[ok]
        w = np.concatenate(ws).astype(np.float32)[ok]
        if add_self_loops:
            loops = np.arange(n, dtype=np.int32)
            src = np.concatenate([src, loops])
            dst = np.concatenate([dst, loops])
            w = np.concatenate([w, np.ones(n, np.float32)])
        deg = np.asarray(graph.degree_sum(ids, edge_types), np.float32)
        self.block = Block(
            edge_src=src,
            edge_dst=dst,
            edge_w=w,
            mask=np.ones(len(src), dtype=bool),
            n_src=n,
            n_dst=n,
            src_deg=deg if gcn_norm else None,
            dst_deg=deg if gcn_norm else None,
        )
        self._ones = np.ones(n, dtype=bool)

    def query(self, roots: np.ndarray) -> MiniBatch:
        roots = np.asarray(roots, dtype=np.uint64)
        rows = np.clip(np.searchsorted(self.ids, roots), 0, len(self.ids) - 1)
        missing = self.ids[rows] != roots
        if missing.any():
            raise ValueError(
                f"{int(missing.sum())} root id(s) not in the graph "
                f"(e.g. {roots[missing][:3].tolist()})"
            )
        rows = rows.astype(np.int32)
        k = self.num_hops
        return MiniBatch(
            feats=(self.X,) * (k + 1),
            masks=(self._ones,) * (k + 1),
            blocks=(self.block,) * k,
            root_idx=rows,
            labels=self.Y[rows],
            target_idx=rows,
        )
