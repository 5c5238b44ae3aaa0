"""Fast synthetic graph construction, array-direct
(counterpart: euler_tpu/datasets/synthetic.py; the same seed gives the
same graph in both packages)."""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
from euler_tpu_torch.graph.store import Graph, GraphStore


def synthetic_meta(
    feat_dim: int, label_dim: int, num_partitions: int
) -> GraphMeta:
    return GraphMeta(
        name="synthetic",
        num_partitions=num_partitions,
        num_node_types=1,
        num_edge_types=1,
        node_features={
            "feat": FeatureSpec("feat", "dense", 0, feat_dim),
            "label": FeatureSpec("label", "dense", 1, label_dim),
        },
        edge_features={},
    )


def shard_arrays(
    p: int,
    num_nodes: int,
    out_degree: int,
    feat_dim: int,
    label_dim: int,
    num_partitions: int,
    rng: np.random.Generator,
    centers: np.ndarray | None = None,
    weighted: bool = False,
) -> dict:
    """Columnar arrays for shard p of the random regular digraph.

    Nodes 1..N are owned by `id % num_partitions`; node i belongs to
    cluster (i % label_dim); features are a noisy cluster signature.
    `centers` [label_dim, feat_dim] must be shared by every shard of one
    graph; None spawns an independent child stream off `rng`.
    """
    all_ids = np.arange(1, num_nodes + 1, dtype=np.uint64)
    ids = all_ids[all_ids % num_partitions == p]
    n = len(ids)
    e = n * out_degree
    dst = rng.integers(1, num_nodes + 1, size=e).astype(np.uint64)
    cluster = (ids.astype(np.int64) % label_dim).astype(np.int64)
    if centers is None:
        centers = rng.spawn(1)[0].normal(0.0, 4.0, (label_dim, feat_dim))
    feat = centers[cluster] + rng.normal(0.0, 1.0, size=(n, feat_dim))
    label = np.eye(label_dim, dtype=np.float32)[cluster]
    # weighted=True: non-unit edge weights in [0.5, 2.0)
    ew = (
        rng.uniform(0.5, 2.0, size=e).astype(np.float32)
        if weighted
        else np.ones(e, dtype=np.float32)
    )

    arrays = {
        "node_ids": ids,
        "node_types": np.zeros(n, dtype=np.int32),
        "node_weights": np.ones(n, dtype=np.float32),
        "edge_src": np.repeat(ids, out_degree),
        "edge_dst": dst,
        "edge_types": np.zeros(e, dtype=np.int32),
        "edge_weights": ew,
        "adj_0_indptr": np.arange(0, e + 1, out_degree, dtype=np.int64),
        "adj_0_dst": dst,
        "adj_0_w": ew,
        "adj_0_eidx": np.arange(e, dtype=np.int64),
        "nf_dense_0": feat.astype(np.float32),
        "nf_dense_1": label,
        "glabel_indptr": np.zeros(1, dtype=np.int64),
        "glabel_nodes": np.zeros(0, dtype=np.uint64),
    }
    # in-adjacency: only edges whose dst lands in this shard
    in_sel = (dst % num_partitions) == p if num_partitions > 1 else slice(None)
    in_dst = dst[in_sel]
    in_src = arrays["edge_src"][in_sel]
    rows = np.searchsorted(ids, in_dst)
    rows = np.clip(rows, 0, max(n - 1, 0))
    ok = (n > 0) & (ids[rows] == in_dst) if n else np.zeros(0, bool)
    rows, in_src = rows[ok], in_src[ok]
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    arrays["inadj_0_indptr"] = np.cumsum(indptr)
    arrays["inadj_0_dst"] = in_src[order]
    arrays["inadj_0_w"] = ew[in_sel][ok][order] if weighted else np.ones(
        len(rows), dtype=np.float32
    )
    arrays["inadj_0_eidx"] = np.full(len(rows), -1, dtype=np.int64)
    return arrays


def random_graph(
    num_nodes: int = 10000,
    out_degree: int = 15,
    feat_dim: int = 32,
    label_dim: int = 2,
    num_partitions: int = 1,
    seed: int = 0,
    weighted: bool = False,
) -> Graph:
    """Uniform random regular digraph with cluster-separable features."""
    rng = np.random.default_rng(seed)
    meta = synthetic_meta(feat_dim, label_dim, num_partitions)
    centers = rng.normal(0.0, 4.0, (label_dim, feat_dim))
    shards = []
    for p in range(num_partitions):
        arrays = shard_arrays(
            p, num_nodes, out_degree, feat_dim, label_dim, num_partitions,
            rng, centers, weighted=weighted,
        )
        n = len(arrays["node_ids"])
        meta.node_weight_sums.append([float(n)])
        meta.edge_weight_sums.append([float(arrays["edge_weights"].sum())])
        shards.append(GraphStore(meta, arrays, part=p))
    return Graph(meta, shards)


def skewed_weighted_graph(num_nodes: int, seed: int) -> Graph:
    """Power-law-ish weighted digraph, arrays built directly: out-degree
    8-15, with 1 % hubs at degree 96-159, f32 edge weights in [0.5, 2),
    16-wide normal features and 2 all-zero label columns — the degree
    regime the paged device lane exists for (counterpart:
    bench.py:367-405 `_skewed_weighted_graph`; the same draws in the same
    order, so a seed gives the same graph)."""
    rng = np.random.default_rng(seed)
    n = int(num_nodes)
    deg = rng.integers(8, 16, n)
    hubs = rng.choice(n, max(n // 100, 1), replace=False)
    deg[hubs] = rng.integers(96, 160, len(hubs))
    e = int(deg.sum())
    dst = rng.integers(1, n + 1, size=e).astype(np.uint64)
    ew = rng.uniform(0.5, 2.0, size=e).astype(np.float32)
    return _out_edge_graph(deg, dst, ew, rng)


def graph_with_degrees(deg, seed: int = 0, unit_weights: bool = False,
                       zero_weight_rows=()) -> Graph:
    """A digraph in which node i + 1 has deg[i] out-edges to uniform random
    nodes, built as `skewed_weighted_graph` is: f32 edge weights in [0.5,
    2) (all 1 with unit_weights), 16-wide normal features, 2 all-zero label
    columns. The edges of the nodes at the 0-based positions
    `zero_weight_rows` all weigh 0, so staging gives those rows degree 0.
    The paged lane's edge cases are degrees: hubs spanning many pages,
    degree-0 rows, a trailing degree-0 node."""
    rng = np.random.default_rng(seed)
    deg = np.asarray(deg, np.int64)
    n, e = len(deg), int(deg.sum())
    dst = rng.integers(1, n + 1, size=e).astype(np.uint64)
    ew = (np.ones(e, np.float32) if unit_weights
          else rng.uniform(0.5, 2.0, size=e).astype(np.float32))
    indptr = np.r_[0, np.cumsum(deg)]
    for r in zero_weight_rows:
        ew[indptr[r] : indptr[r + 1]] = 0.0
    return _out_edge_graph(deg, dst, ew, rng)


def _out_edge_graph(deg, dst, ew, rng) -> Graph:
    """One-shard graph on nodes 1..len(deg), node i + 1's out-edges being
    the next deg[i] of dst / ew; features drawn from `rng`."""
    n, e = len(deg), len(dst)
    ids = np.arange(1, n + 1, dtype=np.uint64)
    feat_dim, label_dim = 16, 2
    meta = synthetic_meta(feat_dim, label_dim, 1)
    arrays = {
        "node_ids": ids,
        "node_types": np.zeros(n, dtype=np.int32),
        "node_weights": np.ones(n, dtype=np.float32),
        "edge_src": np.repeat(ids, deg),
        "edge_dst": dst,
        "edge_types": np.zeros(e, dtype=np.int32),
        "edge_weights": ew,
        "adj_0_indptr": np.r_[0, np.cumsum(deg)].astype(np.int64),
        "adj_0_dst": dst,
        "adj_0_w": ew,
        "adj_0_eidx": np.arange(e, dtype=np.int64),
        "nf_dense_0": rng.normal(0.0, 1.0, (n, feat_dim)).astype(np.float32),
        "nf_dense_1": np.zeros((n, label_dim), np.float32),
        "glabel_indptr": np.zeros(1, dtype=np.int64),
        "glabel_nodes": np.zeros(0, dtype=np.uint64),
    }
    meta.node_weight_sums.append([float(n)])
    meta.edge_weight_sums.append([float(ew.sum())])
    return Graph(meta, [GraphStore(meta, arrays, part=0)])
