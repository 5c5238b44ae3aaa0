"""Whole-graph batches (counterpart: euler_tpu/dataflow/whole.py): the
graph-classification batch `GraphBatch`, its flow `WholeGraphDataFlow`
and source `graph_label_batches`, and the transductive node
classification flow `FullGraphFlow`.

A GraphBatch holds G graphs, each padded to `max_nodes` node slots and
`max_nodes * max_degree` edge slots, flattened into one node table with
a graph id per slot for the pooling.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import Block, DataFlow, MiniBatch
from euler_tpu_torch.graph.store import DEFAULT_ID


@dataclasses.dataclass
class GraphBatch:
    """G whole graphs flattened into one padded node and edge table."""

    feats: np.ndarray | torch.Tensor  # f32[G*Nmax, F]
    node_mask: np.ndarray | torch.Tensor  # bool[G*Nmax]
    block: Block  # the in-graph edges (src and dst index the node table)
    graph_ids: np.ndarray | torch.Tensor  # int32[G*Nmax] graph of each node slot
    labels: np.ndarray | torch.Tensor  # f32[G, C] one-hot classes
    hop_ids: np.ndarray | torch.Tensor | None = None  # int32[G*Nmax] node ids
    n_graphs: int = 0


class WholeGraphDataFlow(DataFlow):
    """GraphBatches for lists of graph labels.

    A label string ending in `_c<k>` (the converter's graph-label format,
    e.g. "g17_c1") classifies its graph into class k; when every label
    carries one and there are at least two classes, batches are one-hot
    over the sorted distinct classes. Otherwise each label is its own
    class."""

    def __init__(
        self,
        graph,
        feature_names,
        max_nodes: int = 32,
        max_degree: int = 8,
        edge_types=None,
        label_to_onehot: bool = True,
        rng=None,
    ):
        super().__init__(graph, feature_names, rng=rng)
        self.max_nodes = max_nodes
        self.max_degree = max_degree
        self.edge_types = edge_types
        self.num_labels = len(graph.meta.graph_labels)
        self.label_to_onehot = label_to_onehot
        parsed = [re.search(r"_c(-?\d+)$", s) for s in graph.meta.graph_labels]
        uniq = sorted({int(m.group(1)) for m in parsed}) if self.num_labels and all(parsed) else []
        if len(uniq) >= 2:
            self.label_class = np.asarray([uniq.index(int(m.group(1))) for m in parsed], np.int64)
            self.num_classes = len(uniq)
        else:
            self.label_class = np.arange(max(self.num_labels, 1))
            self.num_classes = max(self.num_labels, 1)

    def query(self, label_ids: np.ndarray) -> GraphBatch:
        label_ids = np.asarray(label_ids, dtype=np.int64)
        g = len(label_ids)
        nmax = self.max_nodes
        node_tab = np.full((g, nmax), DEFAULT_ID, dtype=np.uint64)
        groups = [nodes[:nmax] for nodes in self.graph.get_graph_by_label(label_ids)]
        for i, nodes in enumerate(groups):
            node_tab[i, : len(nodes)] = nodes
        flat = node_tab.reshape(-1)
        node_mask = flat != DEFAULT_ID
        # the in-graph edges: each node slot's neighbours, kept where the
        # neighbour is a node of the same graph, as its slot in the table
        nbr, w, _, mask, _ = self.graph.get_full_neighbor(
            flat, self.edge_types, max_degree=self.max_degree
        )
        d = nbr.shape[1]
        slot = np.full((g * nmax, d), -1, dtype=np.int64)
        for i in range(g):
            sel = slice(i * nmax, (i + 1) * nmax)
            pos = np.searchsorted(node_tab[i][: len(groups[i])], nbr[sel])
            pos = np.clip(pos, 0, nmax - 1)
            hit = mask[sel] & (node_tab[i][pos] == nbr[sel])
            slot[sel] = np.where(hit, pos + i * nmax, -1)
        # dst: the node whose neighbours were fetched; src: the neighbour's slot
        center = np.repeat(np.arange(g * nmax, dtype=np.int32), d)
        nbr_slot = slot.reshape(-1)
        edge_mask = nbr_slot >= 0
        block = Block(
            edge_src=np.where(edge_mask, nbr_slot, 0).astype(np.int32),
            edge_dst=center,
            edge_w=np.where(edge_mask, w.reshape(-1), 0.0).astype(np.float32),
            mask=edge_mask,
            n_src=g * nmax,
            n_dst=g * nmax,
            grid=d,
        )
        labels = np.zeros((g, self.num_classes), dtype=np.float32)
        if self.label_to_onehot:
            cls = self.label_class[np.clip(label_ids, 0, len(self.label_class) - 1)]
            labels[np.arange(g), cls] = 1.0
        (feats,) = self.node_feats_hops([flat])
        return GraphBatch(
            feats=feats,
            node_mask=node_mask,
            block=block,
            graph_ids=np.repeat(np.arange(g, dtype=np.int32), nmax),
            labels=labels,
            hop_ids=flat.astype(np.int64).astype(np.int32),
            n_graphs=g,
        )


def graph_label_batches(graph, flow: WholeGraphDataFlow, batch_size: int, rng=None):
    """Training source: `batch_size` graph labels drawn uniformly a call,
    as one GraphBatch."""
    rng = rng if rng is not None else np.random.default_rng()

    def fn():
        return (flow.query(graph.sample_graph_label(batch_size, rng=rng)),)

    return fn


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
