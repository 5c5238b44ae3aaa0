"""In-memory columnar graph shard + multi-shard facade, numpy only
(counterpart: euler_tpu/graph/store.py).

This is the part of the JAX package's store that the serving and
training paths run: id lookup, weighted root, edge and neighbor
sampling, the fused multi-hop fanout with feature rows, dense feature
reads, the full adjacency and degrees the device flows stage, the
(node2vec-biased) random walk and the layer-wise (LADIES) draw. The numpy draw order
is the JAX package's exactly, so a seed gives the same sample in both
packages (held by tests/test_torch_graph_flow.py). `Graph.load(native=)`
serves the hot paths from the C++ engine instead (`graph/native.py`).
"""

from __future__ import annotations

import os

import numpy as np

from euler_tpu_torch.graph import format as tformat
from euler_tpu_torch.graph.meta import DENSE, GraphMeta

DEFAULT_ID = np.uint64(0xFFFFFFFFFFFFFFFF)  # padding sentinel for node ids


def split_hops(n_roots: int, counts, *arrays):
    """Split flat per-kind arrays (concatenated over hops) into per-hop
    lists: hop i holds n_roots * prod(counts[:i]) entries (the fused
    fanout's layout)."""
    widths = [int(n_roots)]
    for c in counts:
        widths.append(widths[-1] * int(c))
    offs = np.r_[0, np.cumsum(widths)]
    return [[a[offs[i] : offs[i + 1]] for i in range(len(widths))] for a in arrays]


def lean_wire_ok(roots, hop_w, hop_mask, hop_rows, require_unit_w=True) -> bool:
    """True when a fused-fanout batch keeps the lean wire's invariants:
    unit edge weights (hop_w=None: already proven graph-wide), no valid
    root id truncating to int32 -1, and no valid neighbor resolving to a
    dangling (-1) feature row. Lean hydration rebuilds edge_w as 1.0 and
    validity from feature row > 0 / int32 root_idx, so a batch breaking
    one would train on wrong values. require_unit_w=False checks only the
    id and row invariants (the weighted-lean wire ships bf16 weights)."""
    roots = np.asarray(roots, dtype=np.uint64)
    unit_w = not require_unit_w or hop_w is None or all(
        np.all(w.reshape(-1)[m.reshape(-1)] == 1.0) for w, m in zip(hop_w[1:], hop_mask[1:])
    )
    root32 = roots.astype(np.int64).astype(np.int32)
    alias = bool(((root32 == -1) & (roots != DEFAULT_ID)).any())
    dangling = any(
        bool(((r.reshape(-1) < 0) & m.reshape(-1)).any())
        for r, m in zip(hop_rows[1:], hop_mask[1:])
    )
    return unit_w and not alias and not dangling


def _rng(rng) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


def layerwise_from_full(nbr, w, mask, count: int, rng) -> tuple:
    """LADIES-style layer selection from a batch's full neighbour arrays
    (counterpart: euler_tpu/graph/store.py:100-142). Candidates are
    weighted by their total incident weight from the batch and drawn
    without replacement by a Gumbel top-k (`rng.gumbel` once per
    candidate, in the order of their sorted ids); a frontier that fits
    in `count` is taken whole. The shard and the facade share it: the
    facade gathers the full neighbours first, so a candidate cited from
    several shards is weighted by its global sum.

    Returns (layer_ids u64[count], adj f32[n, count], mask bool[count])."""
    n = nbr.shape[0]
    flat_ids = nbr[mask]
    flat_w = w[mask].astype(np.float64)
    if len(flat_ids) == 0:
        return (np.full(count, DEFAULT_ID, dtype=np.uint64),
                np.zeros((n, count), dtype=np.float32), np.zeros(count, dtype=bool))
    uniq, inv = np.unique(flat_ids, return_inverse=True)
    wsum = np.zeros(len(uniq))
    np.add.at(wsum, inv, flat_w)
    if len(uniq) <= count:
        chosen = np.arange(len(uniq))
    else:
        keys = np.log(np.maximum(wsum, 1e-30)) + rng.gumbel(size=len(uniq))
        chosen = np.sort(np.argpartition(-keys, count - 1)[:count])
    layer = np.full(count, DEFAULT_ID, dtype=np.uint64)
    layer[: len(chosen)] = uniq[chosen]
    lmask = layer != DEFAULT_ID
    # the batch -> layer adjacency
    pos = np.searchsorted(uniq[chosen], nbr.ravel())
    pos = np.clip(pos, 0, len(chosen) - 1)
    hit = mask.ravel() & (uniq[chosen][pos] == nbr.ravel())
    adj = np.zeros((n, count), dtype=np.float32)
    rr = np.repeat(np.arange(n), nbr.shape[1])
    np.add.at(adj, (rr[hit], pos[hit]), w.ravel()[hit])
    return layer, adj, lmask


class _WeightedSampler:
    """O(log n) vectorized weighted sampling via prefix sums (built
    lazily on first draw)."""

    def __init__(self, weights: np.ndarray):
        self._weights = np.asarray(weights)
        self.total = float(np.sum(self._weights, dtype=np.float64))
        self.n = len(self._weights)
        self._cum: np.ndarray | None = None

    @property
    def cum(self) -> np.ndarray:
        if self._cum is None:
            self._cum = np.concatenate(
                [[0.0], np.cumsum(self._weights, dtype=np.float64)]
            )
        return self._cum

    def sample(self, count: int, rng) -> np.ndarray:
        if self.n == 0 or self.total <= 0:
            return np.zeros(count, dtype=np.int64)
        target = _rng(rng).random(count) * self.total
        return np.clip(
            np.searchsorted(self.cum, target, side="right") - 1, 0, self.n - 1
        )


class _CSR:
    """Per-edge-type adjacency with cumulative weights for row sampling."""

    def __init__(self, indptr, dst, w, eidx):
        self.indptr = np.asarray(indptr)
        self.dst = np.asarray(dst)
        self.w = np.asarray(w)
        self.eidx = np.asarray(eidx)
        self._cum = None  # lazy (8 B/edge)
        self._dst_sorted = None  # lazy: within-row dst-sorted view for lookups

    @property
    def cum(self) -> np.ndarray:
        if self._cum is None:
            self._cum = np.concatenate(
                [[0.0], np.cumsum(self.w, dtype=np.float64)]
            )
        return self._cum

    def degrees(self, rows: np.ndarray) -> np.ndarray:
        return self.indptr[rows + 1] - self.indptr[rows]

    def row_weight(self, rows: np.ndarray) -> np.ndarray:
        return self.cum[self.indptr[rows + 1]] - self.cum[self.indptr[rows]]

    def sample_in_rows(self, rows: np.ndarray, rng) -> np.ndarray:
        """One weighted neighbor element index (global) per entry of `rows`."""
        s, e = self.indptr[rows], self.indptr[rows + 1]
        lo, hi = self.cum[s], self.cum[e]
        target = lo + _rng(rng).random(len(rows)) * (hi - lo)
        j = np.searchsorted(self.cum, target, side="right") - 1
        return np.clip(j, s, np.maximum(s, e - 1))

    def sorted_dst(self):
        """(perm, dst_sorted): within-row permutation sorting dst ascending."""
        if self._dst_sorted is None:
            rows = np.repeat(np.arange(len(self.indptr) - 1), np.diff(self.indptr))
            perm = np.lexsort((self.dst, rows))
            self._dst_sorted = (perm, self.dst[perm])
        return self._dst_sorted

    def contains(self, rows: np.ndarray, targets: np.ndarray) -> np.ndarray:
        """Membership: is targets[i] a neighbor of row rows[i]?"""
        perm, dsts = self.sorted_dst()
        s, e = self.indptr[rows], self.indptr[rows + 1]
        out = np.zeros(len(rows), dtype=bool)
        left = s + _searchsorted_segments(dsts, s, e, targets)
        ok = left < e
        out[ok] = dsts[left[ok]] == targets[ok]
        return out


def _searchsorted_segments(sorted_vals, seg_start, seg_end, targets, side="left"):
    """For each i, insertion position of targets[i] within the sorted slice
    sorted_vals[seg_start[i]:seg_end[i]] (vectorized per-segment binary
    search; side as in np.searchsorted)."""
    n = len(targets)
    lo = np.asarray(seg_start).copy()
    hi = np.asarray(seg_end).copy()
    right = side == "right"
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        less = np.zeros(n, dtype=bool)
        if right:
            less[active] = sorted_vals[mid[active]] <= targets[active]
        else:
            less[active] = sorted_vals[mid[active]] < targets[active]
        lo = np.where(active & less, mid + 1, lo)
        hi = np.where(active & ~less, mid, hi)
    return lo - np.asarray(seg_start)


class GraphStore:
    """One graph shard served from columnar arrays."""

    def __init__(self, meta: GraphMeta, arrays: dict[str, np.ndarray], part: int = 0):
        self.meta = meta
        self.part = part
        self.node_ids = np.asarray(arrays["node_ids"])
        self.node_types = np.asarray(arrays["node_types"])
        self.node_weights = np.asarray(arrays["node_weights"])
        self.num_nodes = len(self.node_ids)
        self.edge_src = np.asarray(arrays["edge_src"])
        self.edge_dst = np.asarray(arrays["edge_dst"])
        self.edge_types = np.asarray(arrays["edge_types"])
        self.edge_weights = np.asarray(arrays["edge_weights"])
        self.arrays = arrays
        # data version of this shard: 0 at load (counterpart:
        # euler_tpu/graph/store.py:356); a training checkpoint records it
        self.graph_epoch = 0
        self.adj = [
            _CSR(
                arrays[f"adj_{t}_indptr"],
                arrays[f"adj_{t}_dst"],
                arrays[f"adj_{t}_w"],
                arrays[f"adj_{t}_eidx"],
            )
            for t in range(meta.num_edge_types)
        ]
        self._samplers_n: dict[int, _WeightedSampler] = {}
        self._samplers_e: dict[int, _WeightedSampler] = {}
        self._unit_w: dict[int, bool] = {}  # per type: every weight == 1.0

    def unit_edge_weights(self, edge_types=None) -> bool:
        """True when every out-edge weight of the (selected) types is
        exactly 1.0: the lean wire then ships no weights. A chunked scan
        that stops at the first other weight, cached per type."""
        types = range(self.meta.num_edge_types) if edge_types is None else edge_types
        for t in types:
            key = int(t)
            if key not in self._unit_w:
                ok = True
                if key < len(self.adj):
                    w = self.adj[key].w
                    for lo in range(0, len(w), 1 << 22):
                        if not np.all(w[lo : lo + (1 << 22)] == 1.0):
                            ok = False
                            break
                self._unit_w.setdefault(key, ok)
            if not self._unit_w[key]:
                return False
        return True

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """External u64 ids → local rows; -1 for missing (vectorized)."""
        ids = np.asarray(ids, dtype=np.uint64)
        if self.num_nodes == 0:
            return np.full(len(ids), -1, dtype=np.int64)
        pos = np.searchsorted(self.node_ids, ids)
        pos = np.clip(pos, 0, self.num_nodes - 1)
        ok = self.node_ids[pos] == ids
        return np.where(ok, pos, -1).astype(np.int64)

    def _node_sampler(self, node_type: int) -> _WeightedSampler:
        key = -1 if node_type < 0 else int(node_type)
        if key >= self.meta.num_node_types:
            raise IndexError(f"node type {key} out of range")
        s = self._samplers_n.get(key)
        if s is None:
            w = (
                self.node_weights
                if key < 0
                else np.where(self.node_types == key, self.node_weights, 0.0)
            )
            s = self._samplers_n.setdefault(key, _WeightedSampler(w))
        return s

    def _edge_sampler(self, edge_type: int) -> _WeightedSampler:
        key = -1 if edge_type < 0 else int(edge_type)
        if key >= self.meta.num_edge_types:
            raise IndexError(f"edge type {key} out of range")
        s = self._samplers_e.get(key)
        if s is None:
            w = (
                self.edge_weights
                if key < 0
                else np.where(self.edge_types == key, self.edge_weights, 0.0)
            )
            s = self._samplers_e.setdefault(key, _WeightedSampler(w))
        return s

    def sample_node(self, count: int, node_type: int = -1, rng=None) -> np.ndarray:
        sampler = self._node_sampler(node_type)
        rowz = sampler.sample(count, rng)
        if sampler.total <= 0:
            return np.full(count, DEFAULT_ID, dtype=np.uint64)
        return self.node_ids[rowz]

    def sample_edge(self, count: int, edge_type: int = -1, rng=None) -> np.ndarray:
        """[count, 3] uint64 rows of (src, dst, type), weight-proportional."""
        sampler = self._edge_sampler(edge_type)
        if sampler.total <= 0:
            return np.full((count, 3), DEFAULT_ID, dtype=np.uint64)
        rowz = sampler.sample(count, rng)
        return np.stack(
            [
                self.edge_src[rowz],
                self.edge_dst[rowz],
                self.edge_types[rowz].astype(np.uint64),
            ],
            axis=1,
        )

    def node_type(self, ids: np.ndarray) -> np.ndarray:
        rows = self.lookup(ids)
        out = np.full(len(rows), -1, dtype=np.int32)
        ok = rows >= 0
        out[ok] = self.node_types[rows[ok]]
        return out

    def _csrs(self, edge_types) -> list:
        types = (
            range(self.meta.num_edge_types)
            if edge_types is None
            else edge_types
        )
        return [(t, self.adj[t]) for t in types]

    def sample_neighbor(self, ids, edge_types=None, count: int = 10, rng=None):
        """Weighted neighbor sampling with replacement.

        Returns (nbr_ids u64[n,count], weights f32[n,count], types
        i32[n,count], mask bool[n,count], eidx i64[n,count]).
        """
        rng = _rng(rng)
        ids = np.asarray(ids, dtype=np.uint64)
        rows = self.lookup(ids)
        n = len(rows)
        csrs = self._csrs(edge_types)
        safe = np.maximum(rows, 0)
        # per (node, type) total weights → type choice per draw
        tot = np.stack([c.row_weight(safe) for _, c in csrs], axis=1)  # [n, T]
        tot[rows < 0] = 0.0
        row_total = tot.sum(axis=1)
        mask_any = row_total > 0
        cum_t = np.cumsum(tot, axis=1)
        u = rng.random((n, count)) * row_total[:, None]
        type_choice = (u[:, :, None] >= cum_t[:, None, :]).sum(axis=2)  # [n,count]
        type_choice = np.minimum(type_choice, len(csrs) - 1)

        nbr = np.full((n, count), DEFAULT_ID, dtype=np.uint64)
        w = np.zeros((n, count), dtype=np.float32)
        tt = np.full((n, count), -1, dtype=np.int32)
        eidx = np.full((n, count), -1, dtype=np.int64)
        for k, (t, c) in enumerate(csrs):
            sel = (type_choice == k) & mask_any[:, None] & (rows >= 0)[:, None]
            if not sel.any() or len(c.dst) == 0:
                continue
            r_sel = np.repeat(safe, count).reshape(n, count)[sel]
            has = c.degrees(r_sel) > 0
            j = c.sample_in_rows(r_sel[has], rng)
            flat = np.zeros(sel.sum(), dtype=np.int64)
            flat[has] = j
            vals = np.where(has, c.dst[flat], DEFAULT_ID)
            nbr[sel] = vals
            w[sel] = np.where(has, c.w[flat], 0.0).astype(np.float32)
            tt[sel] = np.where(has, t, -1)
            eidx[sel] = np.where(has, c.eidx[flat], -1)
        mask = nbr != DEFAULT_ID
        return nbr, w, tt, mask, eidx

    def get_full_neighbor(self, ids, edge_types=None, max_degree=None):
        """Padded full adjacency in storage order, types concatenated in
        `edge_types` order (counterpart: store.py:582-643; `sort_by` and
        in-edges are not ported). Returns (nbr u64[n,D], w f32[n,D],
        types i32[n,D], mask bool[n,D], eidx i64[n,D])."""
        ids = np.asarray(ids, dtype=np.uint64)
        rows = self.lookup(ids)
        n = len(rows)
        safe = np.maximum(rows, 0)
        csrs = self._csrs(edge_types)
        degs = np.stack([c.degrees(safe) for _, c in csrs], axis=1)  # [n, T]
        degs[rows < 0] = 0
        cap = int(degs.sum(axis=1).max(initial=0)) if max_degree is None else int(max_degree)
        cap = max(cap, 1)
        nbr = np.full((n, cap), DEFAULT_ID, dtype=np.uint64)
        w = np.zeros((n, cap), dtype=np.float32)
        tt = np.full((n, cap), -1, dtype=np.int32)
        eidx = np.full((n, cap), -1, dtype=np.int64)
        col = np.zeros(n, dtype=np.int64)
        for k, (t, c) in enumerate(csrs):
            d = degs[:, k]
            present = d > 0
            if not present.any():
                continue
            reps = d[present]
            r_idx = np.repeat(np.nonzero(present)[0], reps)
            offs = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
            src_el = np.repeat(c.indptr[safe[present]], reps) + offs
            dest_col = np.repeat(col[present], reps) + offs
            keep = dest_col < cap
            at = (r_idx[keep], dest_col[keep])
            nbr[at] = c.dst[src_el[keep]]
            w[at] = c.w[src_el[keep]]
            tt[at] = t
            eidx[at] = c.eidx[src_el[keep]]
            col += d
        return nbr, w, tt, nbr != DEFAULT_ID, eidx

    def sample_neighbor_layerwise(self, batch_ids, edge_types=None, count: int = 128, rng=None):
        """One candidate layer of `count` nodes for the whole batch, drawn
        in proportion to their incident weight from it, and the batch ->
        layer adjacency (`layerwise_from_full`; counterpart:
        store.py:673-685). Returns (layer_ids u64[count], adj f32[n,
        count], mask bool[count])."""
        rng = _rng(rng)
        batch_ids = np.asarray(batch_ids, dtype=np.uint64)
        nbr, w, _, mask, _ = self.get_full_neighbor(batch_ids, edge_types)
        return layerwise_from_full(nbr, w, mask, count, rng)

    def degree_sum(self, ids, edge_types=None) -> np.ndarray:
        """Total degree per id across the requested edge types (0 if absent)."""
        rows = self.lookup(ids)
        safe = np.maximum(rows, 0)
        total = np.zeros(len(rows), dtype=np.int64)
        for _, c in self._csrs(edge_types):
            total += c.degrees(safe)
        total[rows < 0] = 0
        return total

    def get_dense_feature(self, ids, names: list[str]) -> np.ndarray:
        """[n, sum(dims)] f32; missing nodes → zeros."""
        return self.get_dense_by_rows(self.lookup(ids), names)

    # ---- random walks (counterpart: store.py:944-1013) ------------------

    def random_walk(
        self,
        ids,
        edge_types=None,
        walk_len: int = 3,
        p: float = 1.0,
        q: float = 1.0,
        rng=None,
    ) -> np.ndarray:
        """node2vec walk. Returns u64 [n, walk_len+1]; DEFAULT_ID once stuck."""
        rng = _rng(rng)
        ids = np.asarray(ids, dtype=np.uint64)
        n = len(ids)
        walks = np.full((n, walk_len + 1), DEFAULT_ID, dtype=np.uint64)
        walks[:, 0] = ids
        cur = ids.copy()
        prev = np.full(n, DEFAULT_ID, dtype=np.uint64)
        for step in range(1, walk_len + 1):
            if p == 1.0 and q == 1.0:
                nbr, _, _, mask, _ = self.sample_neighbor(cur, edge_types, 1, rng)
                nxt = np.where(mask[:, 0], nbr[:, 0], DEFAULT_ID)
            else:
                nxt = self._node2vec_step(cur, prev, edge_types, p, q, rng)
            dead = cur == DEFAULT_ID
            nxt[dead] = DEFAULT_ID
            walks[:, step] = nxt
            prev, cur = cur, nxt
        return walks

    def _node2vec_step(self, cur, prev, edge_types, p, q, rng):
        """One node2vec transition. `prev` may be off-shard: the 1/p return
        bias works from ids alone; the "distance-1" membership bias needs
        prev's adjacency and degrades to 1/q when prev is not local."""
        nbr, w, _, mask, _ = self.get_full_neighbor(cur, edge_types)
        n, cap = nbr.shape
        rows = self.lookup(cur)
        # bias: 1/p back to prev, 1 if nbr adjacent to prev, 1/q else
        adj_w = w.astype(np.float64).copy()
        prev = np.asarray(prev, dtype=np.uint64)
        prev_rows = self.lookup(prev)
        has_prev = prev != DEFAULT_ID
        prev_local = prev_rows >= 0
        flat_prev = np.repeat(np.maximum(prev_rows, 0), cap)
        flat_nbr = nbr.ravel()
        is_back = flat_nbr == np.repeat(prev, cap)
        near = np.zeros(n * cap, dtype=bool)
        for _, c in self._csrs(edge_types):
            near |= c.contains(flat_prev, flat_nbr)
        near &= np.repeat(prev_local, cap)
        bias = np.where(is_back, 1.0 / p, np.where(near, 1.0, 1.0 / q))
        bias = np.where(np.repeat(has_prev, cap), bias, 1.0).reshape(n, cap)
        adj_w *= bias
        adj_w[~mask] = 0.0
        tot = adj_w.sum(axis=1)
        ok = tot > 0
        r = _rng(rng).random(n) * np.maximum(tot, 1e-30)
        choice = (r[:, None] >= np.cumsum(adj_w, axis=1)).sum(axis=1)
        choice = np.minimum(choice, cap - 1)
        return np.where(ok & (rows >= 0), nbr[np.arange(n), choice], DEFAULT_ID)

    def get_graph_by_label(self, label_ids) -> list[np.ndarray]:
        """This shard's member nodes of each graph label (an unknown label:
        none), from the shard's `glabel_indptr` / `glabel_nodes` arrays."""
        indptr = self.arrays["glabel_indptr"]
        nodes = self.arrays["glabel_nodes"]
        out = []
        for li in np.asarray(label_ids, dtype=np.int64):
            if 0 <= li < len(indptr) - 1:
                out.append(np.asarray(nodes[indptr[li] : indptr[li + 1]]))
            else:
                out.append(np.zeros(0, dtype=np.uint64))
        return out

    def get_dense_by_rows(self, rows, names) -> np.ndarray:
        """Dense node features by pre-resolved local rows (-1 → zeros)."""
        rows = np.asarray(rows, dtype=np.int64)
        specs = [self.meta.feature_spec(nm, node=True) for nm in names]
        cols = []
        safe = np.maximum(rows, 0)
        for spec in specs:
            vals = self.arrays[f"nf_{DENSE}_{spec.fid}"]
            out = np.asarray(vals[safe], dtype=np.float32)
            out[rows < 0] = 0.0
            cols.append(out)
        return np.concatenate(cols, axis=1) if cols else np.zeros((len(rows), 0), np.float32)


class Graph:
    """Multi-shard facade over in-process shards: ids are scattered to
    their owner shard (`id % P`), queried, and gathered back in input
    order. All methods accept and return padded numpy batches."""

    def __init__(self, meta: GraphMeta, shards: list[GraphStore]):
        self.meta = meta
        self.shards = shards
        self.num_shards = len(shards)
        # shard-weighted root and edge sampling
        self._node_shard_w = np.asarray(meta.node_weight_sums, dtype=np.float64)
        self._edge_shard_w = np.asarray(meta.edge_weight_sums, dtype=np.float64)

    @classmethod
    def from_json(cls, graph_json, num_partitions: int = 1) -> "Graph":
        """In-memory graph from graph.json (a path or a dict)."""
        from euler_tpu_torch.graph.builder import build_from_json

        meta, arrays = build_from_json(graph_json, num_partitions)
        return cls(meta, [GraphStore(meta, a, p) for p, a in enumerate(arrays)])

    @classmethod
    def load(cls, directory: str, mmap: bool = True, native: bool | None = None) -> "Graph":
        """A graph dir (`euler.meta.json` + `part_<p>/` tensor dirs).
        native: True → the C++ engine's hot paths (`NativeGraphStore`);
        None → the engine when the host has a C++ compiler to build it;
        False → the numpy store. A failed engine build raises."""
        meta = GraphMeta.load(directory)
        if native is None:
            from euler_tpu_torch.graph.native import engine_available

            native = engine_available()
        shards = []
        for p in range(meta.num_partitions):
            part_dir = os.path.join(directory, f"part_{p}")
            arrays = tformat.read_arrays(part_dir, mmap)
            if native:
                from euler_tpu_torch.graph.native import NativeGraphStore

                shards.append(NativeGraphStore(meta, arrays, p, part_dir))
            else:
                shards.append(GraphStore(meta, arrays, part=p))
        return cls(meta, shards)

    def _scatter_gather(self, ids, fn, extras=()):
        """fn(shard, sub_ids, *sub_extras) → tuple/array, gathered to input
        order; `extras` are arrays aligned with `ids`, scattered the same
        way."""
        ids = np.asarray(ids, dtype=np.uint64)
        shards = self.shards
        num = len(shards)
        if num == 1 or len(ids) == 0:
            return fn(shards[0], ids, *extras)
        owner = (ids % np.uint64(num)).astype(np.int64)
        index = [np.nonzero(owner == s)[0] for s in range(num)]
        parts = [
            fn(shards[s], ids[sel], *[e[sel] for e in extras]) if len(sel) else None
            for s, sel in enumerate(index)
        ]
        # find a template result to size outputs
        template = next(p for p in parts if p is not None)
        single = not isinstance(template, tuple)
        outs = []
        n = len(ids)
        for a in (template,) if single else template:
            out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
            if a.dtype == np.uint64:
                out[:] = DEFAULT_ID
            elif a.dtype in (np.int32, np.int64):
                out[:] = -1
            outs.append(out)
        for s, sel in enumerate(index):
            if parts[s] is None:
                continue
            res = (parts[s],) if single else parts[s]
            for o, a in zip(outs, res):
                o[sel] = a
        return outs[0] if single else tuple(outs)

    def sample_node(self, count: int, node_type: int = -1, rng=None) -> np.ndarray:
        rng = _rng(rng)
        if isinstance(node_type, str):
            node_type = self.meta.node_type_id(node_type)
        shards = self.shards
        if len(shards) == 1:
            return shards[0].sample_node(count, node_type, rng)
        w = (
            self._node_shard_w.sum(axis=1)
            if node_type < 0
            else self._node_shard_w[:, node_type]
        )
        picks = _WeightedSampler(w).sample(count, rng)
        out = np.empty(count, dtype=np.uint64)
        for s, sh in enumerate(shards):
            sel = picks == s
            if sel.any():
                out[sel] = sh.sample_node(int(sel.sum()), node_type, rng)
        return out

    def sample_edge(self, count: int, edge_type: int = -1, rng=None) -> np.ndarray:
        """[count, 3] u64 (src, dst, type) rows, weight-proportional across
        shards."""
        rng = _rng(rng)
        shards = self.shards
        if len(shards) == 1:
            return shards[0].sample_edge(count, edge_type, rng)
        w = (
            self._edge_shard_w.sum(axis=1)
            if edge_type < 0
            else self._edge_shard_w[:, edge_type]
        )
        picks = _WeightedSampler(w).sample(count, rng)
        out = np.empty((count, 3), dtype=np.uint64)
        for s, sh in enumerate(shards):
            sel = picks == s
            if sel.any():
                out[sel] = sh.sample_edge(int(sel.sum()), edge_type, rng)
        return out

    def sample_graph_label(self, count: int, rng=None) -> np.ndarray:
        """`count` graph labels drawn uniformly (int64 label indices)."""
        n = len(self.meta.graph_labels)
        return _rng(rng).integers(0, max(n, 1), size=count)

    def get_graph_by_label(self, label_ids) -> list[np.ndarray]:
        """The sorted member nodes of each graph label, over every shard."""
        per_shard = [sh.get_graph_by_label(label_ids) for sh in self.shards]
        return [np.sort(np.concatenate([ps[i] for ps in per_shard]))
                for i in range(len(np.asarray(label_ids)))]

    def node_type(self, ids) -> np.ndarray:
        return self._scatter_gather(ids, lambda sh, i: sh.node_type(i))

    def random_walk(self, ids, edge_types=None, walk_len=3, p=1.0, q=1.0, rng=None):
        """u64 [n, walk_len+1] walks (node2vec-biased when p or q != 1);
        DEFAULT_ID once stuck. Across shards each step is owned by the
        current node's shard; the previous id travels along, so the 1/p
        return bias is exact and the distance-1 bias degrades to 1/q when
        the previous node is on another shard."""
        rng = _rng(rng)
        if self.num_shards == 1:
            return self.shards[0].random_walk(ids, edge_types, walk_len, p, q, rng)
        ids = np.asarray(ids, dtype=np.uint64)
        n = len(ids)
        walks = np.full((n, walk_len + 1), DEFAULT_ID, dtype=np.uint64)
        walks[:, 0] = ids
        cur = ids.copy()
        prev = np.full(n, DEFAULT_ID, dtype=np.uint64)
        for step in range(1, walk_len + 1):
            if p == 1.0 and q == 1.0:
                nbr, _, _, mask, _ = self.sample_neighbor(cur, edge_types, 1, rng)
                nxt = np.where(mask[:, 0], nbr[:, 0], DEFAULT_ID)
            else:
                rngs = self._shard_rngs(rng)
                nxt = self._scatter_gather(
                    cur,
                    lambda sh, i, pv: sh._node2vec_step(i, pv, edge_types, p, q, rngs[sh.part]),
                    extras=(prev,),
                )
            nxt = np.asarray(nxt, dtype=np.uint64)
            nxt[cur == DEFAULT_ID] = DEFAULT_ID
            walks[:, step] = nxt
            prev, cur = cur, nxt
        return walks

    def _shard_rngs(self, rng) -> list:
        """One independent child generator per shard, split up-front."""
        seeds = _rng(rng).integers(0, 2**63 - 1, size=self.num_shards)
        return [np.random.default_rng(int(s)) for s in seeds]

    def sample_neighbor(self, ids, edge_types=None, count=10, rng=None):
        rngs = self._shard_rngs(rng)
        return self._scatter_gather(
            ids,
            lambda sh, i: sh.sample_neighbor(i, edge_types, count, rngs[sh.part]),
        )

    def fanout_with_rows(self, ids, edge_types, counts, rng=None):
        """Fused multi-hop fanout incl. global feature rows. Returns
        (hop_ids, hop_w, hop_tt, hop_mask, hop_rows) lists over hops
        0..len(counts). A single shard with a fused call of its own (the
        native engine) answers in that one call; otherwise one
        owner-scattered sampling round per hop, then one batched
        row-resolve round over every hop's ids."""
        rng = _rng(rng)
        if self.num_shards == 1 and hasattr(self.shards[0], "fanout_with_rows"):
            return self.shards[0].fanout_with_rows(ids, edge_types, counts, rng)
        ids = np.asarray(ids, dtype=np.uint64)
        hop_ids = [ids]
        hop_w = [np.ones(len(ids), np.float32)]
        hop_tt = [np.asarray(self.node_type(ids), np.int32)]
        hop_mask = [ids != DEFAULT_ID]
        cur = ids
        for c in counts:
            nbr, w, tt, mask, _ = self.sample_neighbor(
                cur, edge_types, int(c), rng=rng
            )
            cur = nbr.reshape(-1)
            hop_ids.append(cur)
            hop_w.append(w.reshape(-1).astype(np.float32))
            hop_tt.append(tt.reshape(-1).astype(np.int32))
            hop_mask.append(mask.reshape(-1))
        all_rows = np.asarray(
            self.lookup_rows(np.concatenate(hop_ids)), np.int64
        )
        offs = np.r_[0, np.cumsum([len(h) for h in hop_ids])]
        hop_rows = [
            all_rows[offs[i] : offs[i + 1]] for i in range(len(hop_ids))
        ]
        return hop_ids, hop_w, hop_tt, hop_mask, hop_rows

    def unit_edge_weights(self, edge_types=None) -> bool:
        return all(s.unit_edge_weights(edge_types) for s in self.shards)

    def get_dense_by_rows(self, rows, names) -> np.ndarray:
        """Dense features by pre-resolved global rows (-1 → zeros); rows
        are shard-major (the `lookup_rows` space)."""
        rows = np.asarray(rows, dtype=np.int64)
        if self.num_shards == 1:
            return self.shards[0].get_dense_by_rows(rows, names)
        offsets = self._shard_row_offsets()
        owner = np.searchsorted(offsets, rows, side="right") - 1  # -1 → -1
        dims = sum(self.meta.feature_spec(nm, node=True).dim for nm in names)
        out = np.zeros((len(rows), dims), np.float32)
        for s, sh in enumerate(self.shards):
            sel = np.nonzero(owner == s)[0]
            if not len(sel):
                continue
            out[sel] = sh.get_dense_by_rows(rows[sel] - offsets[s], names)
        return out

    def get_dense_feature(self, ids, names) -> np.ndarray:
        return self._scatter_gather(ids, lambda sh, i: sh.get_dense_feature(i, names))

    def get_full_neighbor(self, ids, edge_types=None, max_degree=None):
        if max_degree is None:
            max_degree = int(self.max_degree(ids, edge_types))
        return self._scatter_gather(
            ids, lambda sh, i: sh.get_full_neighbor(i, edge_types, max_degree)
        )

    def sample_neighbor_layerwise(self, batch_ids, edge_types=None, count=128, rng=None):
        """The layer draw over every shard (counterpart: store.py:1675-):
        one shard draws itself; several gather the batch's full
        neighbours first and select once over the merged arrays, so a
        candidate is weighted by its global incident sum."""
        rng = _rng(rng)
        if self.num_shards == 1:
            return self.shards[0].sample_neighbor_layerwise(batch_ids, edge_types, count, rng)
        batch_ids = np.asarray(batch_ids, dtype=np.uint64)
        nbr, w, _, mask, _ = self.get_full_neighbor(batch_ids, edge_types)
        return layerwise_from_full(nbr, w, mask, count, rng)

    def degree_sum(self, ids, edge_types=None) -> np.ndarray:
        return self._scatter_gather(ids, lambda sh, i: sh.degree_sum(i, edge_types))

    def max_degree(self, ids, edge_types=None) -> int:
        return max(int(np.max(self.degree_sum(ids, edge_types), initial=0)), 1)

    def dense_feature_table(self, names) -> np.ndarray:
        """f32 [total_nodes, F] dense features of every node, shard-major
        (the `lookup_rows` order): the host source of a device feature
        cache."""
        parts = [
            sh.get_dense_by_rows(np.arange(sh.num_nodes, dtype=np.int64), names)
            for sh in self.shards
            if sh.num_nodes
        ]
        return np.concatenate(parts, axis=0) if parts else np.zeros((0, 0), np.float32)

    def _shard_row_offsets(self) -> np.ndarray:
        return np.cumsum([0] + [s.num_nodes for s in self.shards])

    def lookup_rows(self, ids) -> np.ndarray:
        """u64 ids → global dense rows (shard-major order); -1 for missing."""
        offsets = self._shard_row_offsets()

        def fn(shard, sub):
            r = shard.lookup(sub)
            return np.where(r >= 0, r + offsets[shard.part], -1)

        return np.asarray(self._scatter_gather(ids, fn), dtype=np.int64)
