"""Sampled-fanout (GraphSAGE) and full-neighbor dataflows with padded
static shapes (counterpart: euler_tpu/dataflow/sage.py, local graphs;
dense and rows feature modes, the lean wire)."""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import (
    DataFlow,
    MiniBatch,
    fanout_block,
    gather_unique,
)
from euler_tpu_torch.graph.store import DEFAULT_ID, lean_wire_ok


class SageDataFlow(DataFlow):
    def __init__(
        self,
        graph,
        feature_names,
        edge_types=None,
        fanouts=(10, 10),
        label_feature=None,
        label_dim=None,
        rng=None,
        feature_mode="dense",
        lazy_blocks: bool = False,
        lean: bool = False,
    ):
        """lazy_blocks=True leaves the grid edge ids to `hydrate_blocks`.
        lean=True (rows mode only) ships int32 feature rows and labels,
        and leaves masks, edge ids and unit weights to hydrate_blocks; on
        a weighted graph it ships bf16 weights beside the rows (decided
        once, here, through `unit_edge_weights`). A batch that breaks a
        lean invariant (`lean_wire_ok`) ships full arrays, and so does
        every later batch of the flow (the downgrade is sticky, so one
        run keeps one batch structure); a lean-configured flow never
        ships hop_ids."""
        if lean and feature_mode != "rows":
            raise ValueError("lean=True requires feature_mode='rows'")
        super().__init__(graph, feature_names, label_feature, label_dim, rng, feature_mode)
        self.edge_types = edge_types
        self.fanouts = list(fanouts)
        self.lazy_blocks = lazy_blocks or lean
        self.lean = lean
        self._lean_off = False
        self._lean_w = False
        if lean:
            probe = getattr(graph, "unit_edge_weights", None)
            self._lean_w = probe is not None and not probe(edge_types)

    def minibatch(self, batch_size: int, node_type: int = -1) -> MiniBatch:
        """One training minibatch over `batch_size` sampled roots (the
        local route; a remote graph's one-call route waits for the
        distributed client)."""
        roots = self.graph.sample_node(batch_size, node_type, rng=self.rng)
        return self.query(roots)

    def _hop_ids(self, hop_ids):
        if self.lean:
            return None
        return tuple(ids.astype(np.int64).astype(np.int32) for ids in hop_ids)

    def query(self, roots: np.ndarray) -> MiniBatch:
        roots = np.asarray(roots, dtype=np.uint64)
        fused = getattr(self.graph, "fanout_with_rows", None)
        if fused is not None:
            # fused path: one call yields every hop's ids, weights, masks
            # AND global feature rows
            hop_ids, hop_w, _, hop_masks, hop_rows = fused(
                roots, self.edge_types, self.fanouts, rng=self.rng
            )
            return self._from_fused(roots, hop_ids, hop_w, hop_masks, hop_rows)
        # no fused rows: nothing to derive lean masks from, full arrays
        hop_ids = [roots]
        hop_masks = [roots != DEFAULT_ID]
        blocks = []
        cur = roots
        for k in self.fanouts:
            nbr, w, _, mask, _ = self.graph.sample_neighbor(
                cur, self.edge_types, k, rng=self.rng
            )
            blocks.append(fanout_block(len(cur), k, w, mask, lazy=self.lazy_blocks))
            cur = nbr.reshape(-1)
            hop_ids.append(cur)
            hop_masks.append(mask.reshape(-1))
        # padded slots hold DEFAULT_ID → feature fetch returns zeros
        return MiniBatch(
            feats=self.node_feats_hops(hop_ids),
            masks=tuple(hop_masks),
            blocks=tuple(blocks),
            root_idx=roots.astype(np.int64).astype(np.int32),
            labels=self.labels_of(roots),
            hop_ids=self._hop_ids(hop_ids),
        )

    def _from_fused(self, roots, hop_ids, hop_w, hop_masks, hop_rows) -> MiniBatch:
        # hop-0 validity matches the per-hop path (any non-default id
        # counts, even if absent from the store — its features are zero)
        hop_masks = [roots != DEFAULT_ID] + list(hop_masks[1:])
        lean = self.lean and not self._lean_off
        if lean:
            # weighted graphs skip the unit-weight check: their lean
            # batches ship bf16 weights
            lean = lean_wire_ok(roots, hop_w, hop_masks, hop_rows,
                                require_unit_w=not self._lean_w)
            if not lean:
                self._lean_off = True
        lean_w = lean and self._lean_w
        blocks = []
        width = len(roots)
        for k, w, mask in zip(self.fanouts, hop_w[1:], hop_masks[1:]):
            blocks.append(fanout_block(
                width, k, w, mask, lazy=self.lazy_blocks, ship_w=(not lean) or lean_w,
                ship_mask=not lean, w_dtype=torch.bfloat16 if lean_w else np.float32))
            width *= k
        if self.feature_mode == "rows":
            feats = tuple(np.where(r >= 0, r + 1, 0).astype(np.int32) for r in hop_rows)
        elif self.feature_names and hasattr(self.graph, "get_dense_by_rows"):
            # reuse the rows the fanout already resolved, deduplicated
            # across hops: a hot node's row is read once per batch
            feats = tuple(
                gather_unique(
                    hop_rows,
                    lambda u: self.graph.get_dense_by_rows(u, self.feature_names),
                )
            )
        else:
            feats = self.node_feats_hops(hop_ids)
        return MiniBatch(
            feats=feats,
            masks=None if lean else tuple(hop_masks),
            blocks=tuple(blocks),
            root_idx=roots.astype(np.int64).astype(np.int32),
            labels=self.labels_of(roots),
            hop_ids=self._hop_ids(hop_ids),
        )


class FullNeighborDataFlow(DataFlow):
    """Full-neighbor dataflow with a degree cap (counterpart:
    euler_tpu/dataflow/sage.py:317-394, the local path).

    Every hop expands each node to its neighbor list in storage order,
    cut at `max_degree` and padded to it, so the shapes are static and a
    root set always gives the same batch. Not ported yet: the remote
    planner (`_query_plan`, which waits for the distributed client) and
    `gcn_norm` (the true degrees GCNConv reads); asking for either
    raises.
    """

    def __init__(
        self,
        graph,
        feature_names,
        edge_types=None,
        num_hops=2,
        max_degree=32,
        label_feature=None,
        label_dim=None,
        rng=None,
        feature_mode="dense",
        gcn_norm: bool = False,
    ):
        if gcn_norm:
            raise NotImplementedError(
                "FullNeighborDataFlow(gcn_norm=True) is not ported yet: it "
                "feeds GCNConv, which the port does not have"
            )
        shards = getattr(graph, "shards", None)
        if shards and all(hasattr(sh, "call") for sh in shards):
            # a graph of wire shards (euler_tpu/query/plan.py:665-667)
            raise NotImplementedError(
                "FullNeighborDataFlow over a remote graph (the query planner) "
                "is not ported yet"
            )
        super().__init__(graph, feature_names, label_feature, label_dim, rng, feature_mode)
        self.edge_types = edge_types
        self.num_hops = num_hops
        self.max_degree = max_degree

    def query(self, roots: np.ndarray) -> MiniBatch:
        roots = np.asarray(roots, dtype=np.uint64)
        hop_ids = [roots]
        hop_masks = [roots != DEFAULT_ID]
        blocks = []
        cur = roots
        for _ in range(self.num_hops):
            nbr, w, _, mask, _ = self.graph.get_full_neighbor(
                cur, self.edge_types, max_degree=self.max_degree
            )
            blocks.append(fanout_block(len(cur), self.max_degree, w, mask))
            cur = nbr.reshape(-1)
            hop_ids.append(cur)
            hop_masks.append(mask.reshape(-1))
        return MiniBatch(
            feats=self.node_feats_hops(hop_ids),
            masks=tuple(hop_masks),
            blocks=tuple(blocks),
            root_idx=roots.astype(np.int64).astype(np.int32),
            labels=self.labels_of(roots),
            hop_ids=tuple(ids.astype(np.int64).astype(np.int32) for ids in hop_ids),
        )
