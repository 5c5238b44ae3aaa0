"""Padded mini-batch subgraph containers + base dataflow
(counterpart: euler_tpu/dataflow/base.py).

Hop i holds exactly batch * prod(fanouts[:i]) node slots, invalid slots
carry a mask, and every downstream op is a fixed-shape gather or segment
op. A `Block` is the bipartite edge set between hop i+1 ("src", the
sampled neighbors) and hop i ("dst").

Dataflows build batches of numpy arrays on the host; `to_device` moves a
batch onto a torch device. uint64 node ids stay in numpy: only the int32
rows and indices, the masks and the f32 arrays become tensors. In
feature_mode "rows" a batch carries int32 feature rows (row + 1, 0 =
padding) for a `DeviceFeatureCache`; a lean batch leaves out what
`hydrate_blocks` rebuilds on the device (masks, edge ids, unit weights)
and may carry its edge weights as a CPU bfloat16 tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Block:
    """Edges from a src node table into a dst node table (one hop)."""

    # lean batches of the device flows leave edge_src/edge_dst, mask and
    # (unweighted) edge_w as None; `hydrate_blocks` rebuilds them
    edge_src: np.ndarray | torch.Tensor | None  # int32[E] rows into the src hop table
    edge_dst: np.ndarray | torch.Tensor | None  # int32[E] rows into the dst hop table
    edge_w: np.ndarray | torch.Tensor | None  # f32[E] (bf16 on lean batches) edge weights
    mask: np.ndarray | torch.Tensor | None  # bool[E] valid-edge mask
    n_src: int
    n_dst: int
    # >0 when edges are grid-structured (dst row i owns slots
    # [i*grid, (i+1)*grid)); unlocks the fused gather_weighted_sum path
    grid: int = 0
    # the true graph degrees (f32, self loop not included) of the src and
    # dst hop's nodes, attached by the full-neighbor and whole-graph flows
    # under gcn_norm=True for GCNConv's exact symmetric normalization
    src_deg: np.ndarray | torch.Tensor | None = None  # f32[n_src]
    dst_deg: np.ndarray | torch.Tensor | None = None  # f32[n_dst]


@dataclasses.dataclass
class MiniBatch:
    """One padded multi-hop subgraph batch.

    feats[i]  — f32[N_i, F] node features of hop i (hop 0 = roots), or
                int32[N_i] feature rows on a lean batch (0 = padding)
    masks[i]  — bool[N_i] node validity (None on a lean batch)
    blocks[i] — edges hop i+1 → hop i  (len == num hops)
    root_idx  — int32[B] root node ids
    labels    — optional f32[B, L] supervised targets
    hop_ids   — optional int32 per-hop node ids (host only)
    target_idx — whole-graph flows: the hop-0 rows that carry the loss and
                the metric (labels then has one row a target); None means
                every hop-0 row is a target
    """

    feats: tuple
    masks: tuple | None
    blocks: tuple
    root_idx: np.ndarray | torch.Tensor
    labels: np.ndarray | torch.Tensor | None = None
    hop_ids: tuple | None = None
    target_idx: np.ndarray | torch.Tensor | None = None


def _tensor(a, device: torch.device, pinned: bool) -> torch.Tensor | None:
    if a is None:  # a leaf a lean batch leaves out
        return None
    if isinstance(a, torch.Tensor):
        if pinned and a.device.type == "cpu":
            return a.pin_memory().to(device, non_blocking=True)
        return a.to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if pinned:
        # a page-locked copy, so the copy to the card runs asynchronously
        # on the caller's current stream
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_device(batch: MiniBatch, device, pinned: bool = False) -> MiniBatch:
    """The batch with every array as a tensor on `device` (the port's
    counterpart of the JAX `Estimator._put` + `hydrate_blocks`); arrays
    that already are tensors are moved, or kept where they are. hop_ids
    stay on the host: no model of the port reads them on the device; the
    true degrees and target_idx of the full-graph flows move with the
    rest, and an array the batch holds more than once (the full-graph
    flow's one node table and block) is moved once. pinned=True stages
    each host array in page-locked memory and copies it without
    blocking: the caller must order its use after the current
    stream's copies (the Prefetcher records an event). A lean batch's
    missing leaves stay None, and its bf16 edge weights stay bf16."""
    device = torch.device(device)
    moved = {}  # one copy of an array the batch holds more than once

    def put(a):
        if a is None:
            return None
        if id(a) not in moved:
            moved[id(a)] = (a, _tensor(a, device, pinned))
        return moved[id(a)][1]

    blocks = tuple(
        dataclasses.replace(
            b,
            edge_src=put(b.edge_src),
            edge_dst=put(b.edge_dst),
            edge_w=put(b.edge_w),
            mask=put(b.mask),
            src_deg=put(b.src_deg),
            dst_deg=put(b.dst_deg),
        )
        for b in batch.blocks
    )
    return MiniBatch(
        feats=tuple(put(f) for f in batch.feats),
        masks=None if batch.masks is None else tuple(put(m) for m in batch.masks),
        blocks=blocks,
        root_idx=put(batch.root_idx),
        labels=None if batch.labels is None else put(batch.labels),
        hop_ids=batch.hop_ids,
        target_idx=put(batch.target_idx),
    )


def upgrade_lean_host(batch):
    """Host-side (numpy) rebuild of a lean batch's masks and edge
    weights, giving it the structure of a downgraded batch of the same
    lean flow (counterpart: euler_tpu/dataflow/base.py:221-248). Exact
    for every batch a lean flow shipped lean; lets a steps_per_call window
    that mixes lean and downgraded batches stack."""
    if not isinstance(batch, MiniBatch) or batch.masks is not None:
        return batch
    masks = tuple(
        (np.asarray(f) > 0)
        if np.issubdtype(np.asarray(f).dtype, np.integer)
        else np.ones(np.asarray(f).shape[0], bool)
        for f in batch.feats
    )
    masks = (np.asarray(batch.root_idx) != -1,) + masks[1:]
    blocks = []
    for h, b in enumerate(batch.blocks):
        if b.mask is None:
            b = dataclasses.replace(b, mask=masks[h + 1].reshape(-1))
        if b.edge_w is None:
            b = dataclasses.replace(b, edge_w=np.asarray(b.mask, np.float32))
        elif isinstance(b.edge_w, torch.Tensor):  # the weighted-lean wire's bf16
            b = dataclasses.replace(b, edge_w=b.edge_w.float().numpy())
        elif b.edge_w.dtype != np.float32:
            b = dataclasses.replace(b, edge_w=np.asarray(b.edge_w, np.float32))
        blocks.append(b)
    return dataclasses.replace(batch, masks=masks, blocks=tuple(blocks))


def hydrate_blocks(batch):
    """Rebuild the pieces a lean batch leaves out, on its device
    (counterpart: euler_tpu/dataflow/base.py:251-297):

    - batch.masks is None: node validity = rows-mode feat > 0, and hop 0
      = root_idx != -1;
    - block.mask is None: the src hop's node mask;
    - block.edge_w is None: the mask as f32; a bf16 edge_w is upcast;
    - block.edge_src is None: the grid's iota edge ids.
    """
    if not isinstance(batch, MiniBatch):
        return batch
    masks = batch.masks
    if masks is None:
        masks = tuple(
            torch.ones(f.shape[0], dtype=torch.bool, device=f.device)
            if f.is_floating_point()
            else f > 0
            for f in batch.feats
        )
        masks = (batch.root_idx != -1,) + masks[1:]
    blocks = []
    for h, b in enumerate(batch.blocks):
        if b.mask is None:
            b = dataclasses.replace(b, mask=masks[h + 1].reshape(-1))
        if b.edge_w is None:
            b = dataclasses.replace(b, edge_w=b.mask.float())
        elif b.edge_w.dtype != torch.float32:
            b = dataclasses.replace(b, edge_w=b.edge_w.float())
        if b.edge_src is None:
            dev = b.mask.device
            b = dataclasses.replace(
                b,
                edge_src=torch.arange(b.n_src, dtype=torch.int32, device=dev),
                edge_dst=torch.arange(b.n_dst, dtype=torch.int32, device=dev)
                .repeat_interleave(b.grid),
            )
        blocks.append(b)
    return dataclasses.replace(batch, masks=masks, blocks=tuple(blocks))


def gather_unique(ids_list, fetch):
    """Cross-hop unique-ID coalescing: ONE deduplicated fetch covers every
    hop, results scattered back by inverse index. `fetch(uniq)` sees each
    id once; because the fetched verbs are deterministic per id, the
    result is bit-identical to fetching each hop directly."""
    arrs = [np.asarray(a).reshape(-1) for a in ids_list]
    flat = np.concatenate(arrs) if arrs else np.empty(0, np.uint64)
    uniq, inv = np.unique(flat, return_inverse=True)
    out_flat = np.asarray(fetch(uniq))[inv]
    offs = np.cumsum([0] + [a.size for a in arrs])
    return [out_flat[offs[i] : offs[i + 1]] for i in range(len(arrs))]


class DataFlow:
    """Base: fetches features and labels; subclasses build the hop
    structure. query(roots) → MiniBatch of numpy arrays (host)."""

    def __init__(
        self,
        graph,
        feature_names: list[str],
        label_feature: str | None = None,
        label_dim: int | None = None,
        rng: np.random.Generator | None = None,
        feature_mode: str = "dense",
    ):
        """feature_mode "dense" ships f32 features; "rows" ships int32
        feature rows (row + 1, 0 = padding) into a DeviceFeatureCache."""
        if feature_mode not in ("dense", "rows"):
            raise ValueError(f"unknown feature_mode {feature_mode!r}")
        self.graph = graph
        self.feature_names = list(feature_names)
        self.label_feature = label_feature
        self.label_dim = label_dim
        self.rng = rng if rng is not None else np.random.default_rng()
        self.feature_mode = feature_mode

    def _rows(self, ids) -> np.ndarray:
        """int32 feature rows of ids: global row + 1, 0 for a missing id."""
        rows = np.asarray(self.graph.lookup_rows(ids))
        return np.where(rows >= 0, rows + 1, 0).astype(np.int32)

    def node_feats(self, ids: np.ndarray) -> np.ndarray:
        if self.feature_mode == "rows":
            return self._rows(ids)
        if not self.feature_names:
            return np.zeros((len(ids), 0), dtype=np.float32)
        return self.graph.get_dense_feature(ids, self.feature_names)

    def node_feats_hops(self, ids_list) -> tuple:
        """Per-hop `node_feats`, with ids deduplicated across hops before
        the fetch."""
        if self.feature_mode == "rows":
            fetch = self._rows
        elif not self.feature_names:
            return tuple(
                np.zeros((len(np.asarray(i)), 0), np.float32) for i in ids_list
            )
        else:
            def fetch(u):
                return self.graph.get_dense_feature(u, self.feature_names)
        return tuple(gather_unique(ids_list, fetch))

    def labels_of(self, ids: np.ndarray) -> np.ndarray | None:
        if self.label_feature is None:
            return None
        return self.graph.get_dense_feature(ids, [self.label_feature])

    def query(self, roots: np.ndarray) -> MiniBatch:
        raise NotImplementedError

    def query_padded(
        self, roots: np.ndarray, batch_size: int
    ) -> tuple[MiniBatch, int]:
        """query() at a FIXED root count: pads `roots` to `batch_size` by
        repeating the final id, so callers with variable request sizes
        (serving buckets) always run one shape per bucket. Returns
        (batch, n_valid); rows [n_valid:] of the output are padding."""
        roots = np.asarray(roots, dtype=np.uint64)
        n = len(roots)
        if n == 0 or n > batch_size:
            raise ValueError(
                f"need 1..{batch_size} roots for this bucket, got {n}"
            )
        if n < batch_size:
            roots = np.concatenate(
                [roots, np.repeat(roots[-1:], batch_size - n)]
            )
        return self.query(roots), n


def fanout_block(
    batch: int,
    fanout: int,
    w: np.ndarray,
    mask: np.ndarray,
    lazy: bool = False,
    ship_w: bool = True,
    ship_mask: bool = True,
    w_dtype=np.float32,
) -> Block:
    """Block for sampled fanout: src j feeds dst j // fanout.

    lazy=True leaves edge_src/edge_dst out (a function of batch and
    fanout that `hydrate_blocks` rebuilds on the device); ship_mask=False
    and ship_w=False leave out the edge mask (rebuilt from the src hop's
    rows-mode validity) and the weights (rebuilt as 1.0 where valid): only
    for rows-mode batches of unit-weight graphs. w_dtype=torch.bfloat16
    ships the weights as a CPU bfloat16 tensor (round to nearest even),
    the weighted-lean wire; hydrate_blocks widens them on the device."""
    e = batch * fanout
    if not ship_w:
        edge_w = None
    elif w_dtype is torch.bfloat16:
        edge_w = torch.from_numpy(np.asarray(w, np.float32).reshape(-1)).to(torch.bfloat16)
    else:
        edge_w = w.reshape(-1).astype(w_dtype)
    return Block(
        edge_src=None if lazy else np.arange(e, dtype=np.int32),
        edge_dst=None if lazy else np.repeat(np.arange(batch, dtype=np.int32), fanout),
        edge_w=edge_w,
        mask=mask.reshape(-1) if ship_mask else None,
        n_src=e,
        n_dst=batch,
        grid=fanout,
    )
