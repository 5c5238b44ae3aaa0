"""Calibrated quality stand-ins, numpy only
(counterpart: euler_tpu/datasets/quality.py:53-185).

`products_like_graph` is the ogbn-products-shaped graph of the JAX
package's north-star quality config: the same seed gives the same
arrays, built into the port's `Graph`.
"""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
from euler_tpu_torch.graph.store import Graph, GraphStore


def products_like_graph(
    num_nodes: int = 50_000,
    num_classes: int = 47,
    feature_dim: int = 100,
    avg_degree: int = 16,
    homophily: float = 0.57,
    noise: float = 3.45,
    train_frac: float = 0.08,
    val_frac: float = 0.02,
    seed: int = 0,
    num_partitions: int = 1,
):
    """ogbn-products at 1/50 scale: Zipf-like class sizes, 100-wide
    Gaussian class-centre features with `noise` tuned so a feature-only
    model lands near the published MLP baseline (0.6106), and
    homophilous co-purchase edges tuned so sampled-fanout GraphSAGE
    lands near the published score (0.7849). Node ids are 1..num_nodes;
    dense features "feature" [F] and one-hot "label" [num_classes].

    Returns (Graph, types int64[N]) with types 0/1/2 = train/val/test.
    """
    rng = np.random.default_rng(seed)
    mass = 1.0 / np.arange(1, num_classes + 1) ** 0.7
    mass /= mass.sum()
    classes = rng.choice(num_classes, size=num_nodes, p=mass)
    by_class = [np.nonzero(classes == c)[0] for c in range(num_classes)]
    if min(len(p_) for p_ in by_class) == 0:
        # an empty class would collapse the homophilous pools below
        raise ValueError(
            "products_like_graph: a class drew zero members; increase "
            "num_nodes or decrease num_classes"
        )

    # heavy-tailed out-degrees, co-purchase style
    deg = np.clip(
        rng.lognormal(np.log(avg_degree * 0.7), 0.8, num_nodes), 2, 120
    ).astype(np.int64)
    e = int(deg.sum())
    src = np.repeat(np.arange(num_nodes), deg)
    same = rng.random(e) < homophily
    # homophilous endpoints: uniform within the src's class
    pool_offsets = np.r_[0, np.cumsum([len(p) for p in by_class])]
    pools = np.concatenate(by_class)
    dst = rng.integers(0, num_nodes, e)
    cls_of_src = classes[src[same]]
    lo = pool_offsets[cls_of_src]
    hi = pool_offsets[cls_of_src + 1]
    dst[same] = pools[
        lo + (rng.random(int(same.sum())) * (hi - lo)).astype(np.int64)
    ]

    centers = rng.normal(0.0, 1.0, (num_classes, feature_dim))
    feat = centers[classes] + noise * rng.normal(
        0.0, 1.0, (num_nodes, feature_dim)
    )
    labels = np.zeros((num_nodes, num_classes), np.float32)
    labels[np.arange(num_nodes), classes] = 1.0

    types = np.full(num_nodes, 2, np.int64)
    perm = rng.permutation(num_nodes)
    n_tr = int(train_frac * num_nodes)
    n_val = int(val_frac * num_nodes)
    types[perm[:n_tr]] = 0
    types[perm[n_tr : n_tr + n_val]] = 1

    ids = np.arange(1, num_nodes + 1, dtype=np.uint64)
    indptr = np.r_[0, np.cumsum(deg)]  # src is sorted: CSR directly
    parts = int(num_partitions)
    meta = GraphMeta(
        num_node_types=3,
        num_edge_types=1,
        node_features={
            "feature": FeatureSpec("feature", "dense", 0, feature_dim),
            "label": FeatureSpec("label", "dense", 1, num_classes),
        },
        edge_features={},
        num_partitions=parts,
    )
    feat32 = feat.astype(np.float32)
    stores = []
    for p in range(parts):
        own = np.nonzero(ids % np.uint64(parts) == p)[0]  # id % P ownership
        # this partition's rows of the global CSR, re-packed
        lens = deg[own]
        starts = indptr[own]
        total = int(lens.sum())
        row0 = np.repeat(np.cumsum(lens) - lens, lens)
        idx = np.repeat(starts, lens) + (np.arange(total) - row0)
        meta.node_weight_sums.append(
            [float((types[own] == t).sum()) for t in range(3)]
        )
        meta.edge_weight_sums.append([float(total)])
        arrays = {
            "node_ids": ids[own],
            "node_types": types[own].astype(np.int32),
            "node_weights": np.ones(len(own), np.float32),
            "edge_src": ids[src[idx]],
            "edge_dst": ids[dst[idx]],
            "edge_types": np.zeros(total, np.int32),
            "edge_weights": np.ones(total, np.float32),
            "adj_0_indptr": np.r_[0, np.cumsum(lens)],
            "adj_0_dst": ids[dst[idx]],
            "adj_0_w": np.ones(total, np.float32),
            "adj_0_eidx": np.arange(total, dtype=np.int64),
            "nf_dense_0": feat32[own],
            "nf_dense_1": labels[own],
            "glabel_indptr": np.zeros(1, np.int64),
            "glabel_nodes": np.zeros(0, np.uint64),
        }
        stores.append(GraphStore(meta, arrays, part=p))
    return Graph(meta, stores), types
