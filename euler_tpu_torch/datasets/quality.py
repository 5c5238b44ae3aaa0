"""Calibrated quality stand-ins, numpy only
(counterpart: euler_tpu/datasets/quality.py:53-185, 217-480).

`products_like_graph` is the ogbn-products-shaped graph of the JAX
package's north-star quality config: the same seed gives the same
arrays, built into the port's `Graph`. `cora_like_json` (the skip-gram
and conv bands), `fb15k_like` (the TransX bands) and `mutag_like_json`
(the graph-classification bands) give the JAX package's graph.json for
the same arguments.
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


def fb15k_like(
    n_ent: int = 2000,
    n_rel: int = 40,
    dim: int = 16,
    n_train: int = 30000,
    n_test: int = 1000,
    tail_cands: int = 4,
    noise_frac: float = 0.25,
    seed: int = 0,
    projective: bool = False,
) -> tuple[dict, np.ndarray]:
    """Calibrated KG stand-in for the TransX quality bands.

    FB15k itself (14951 entities, 483k triples) cannot be downloaded here;
    this plants real translational structure instead: ground-truth entity
    points E and relation offsets R, each triple's tail drawn from the
    `tail_cands` nearest entities to E[h]+R[r] (1-to-N ambiguity, like
    FB15k's multi-valued relations) with a `noise_frac` of uniform-random
    tails (unlearnable mass). The knobs are tuned so a correct TransE
    lands near FB15k's published *relative* numbers (examples/TransX/
    README.md:43-49: MeanRank 197 = 1.3% of the entity count, Hit@10
    39.7%) while untrained embeddings stay at MeanRank ≈ n_ent/2 — the
    control that separates "learned the structure" from "easy dataset".

    projective=True plants PER-RELATION SUBSPACE structure instead:
    each relation owns an orthogonal map P_r and tails sit near
    P_r·E[h] + R[r]. A pure translation (TransE) underfits this geometry
    while projection variants (TransR/TransD) can represent it exactly —
    the discriminating control for the projection machinery, mirroring
    how TransR out-Hit@10s TransE on real FB15k
    (examples/TransX/README.md:43-48).

    Returns (graph_json, test_triples int32 [n_test, 3] of (h, r, t)).
    """
    rng = np.random.default_rng(seed)
    E = rng.uniform(-1.0, 1.0, (n_ent, dim))
    R = rng.uniform(-0.6, 0.6, (n_rel, dim))
    if projective:
        # per-relation linear map: an equal blend of identity and a
        # random orthogonal matrix (QR of a gaussian) — NOT itself
        # orthogonal; the identity component keeps tails correlated with
        # heads so the structure stays learnable, the orthogonal
        # component rotates each relation into its own subspace
        P = np.empty((n_rel, dim, dim))
        for k in range(n_rel):
            q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
            P[k] = 0.5 * np.eye(dim) + 0.5 * q
    else:
        P = None

    def make_triples(count):
        h = rng.integers(0, n_ent, count)
        r = rng.integers(0, n_rel, count)
        t = np.empty(count, dtype=np.int64)
        # nearest-entity tails in chunks (count × n_ent distance matrix)
        for lo in range(0, count, 4096):
            hi = min(lo + 4096, count)
            if P is not None:
                target = (
                    np.einsum("bd,bde->be", E[h[lo:hi]], P[r[lo:hi]])
                    + R[r[lo:hi]]
                )
            else:
                target = E[h[lo:hi]] + R[r[lo:hi]]
            d2 = ((target[:, None, :] - E[None, :, :]) ** 2).sum(-1)
            near = np.argpartition(d2, tail_cands, axis=1)[:, :tail_cands]
            pick = rng.integers(0, tail_cands, hi - lo)
            t[lo:hi] = near[np.arange(hi - lo), pick]
        noise = rng.random(count) < noise_frac
        t[noise] = rng.integers(0, n_ent, int(noise.sum()))
        return np.stack([h, r, t], axis=1)

    train = make_triples(n_train)
    test = make_triples(n_test)
    nodes = [
        {"id": i + 1, "type": 0, "weight": 1.0, "features": []}
        for i in range(n_ent)
    ]
    edges = [
        {
            "src": int(h) + 1,
            "dst": int(t) + 1,
            "type": int(r),
            "weight": 1.0,
            "features": [],
        }
        for h, r, t in train
    ]
    test32 = np.stack(
        [test[:, 0] + 1, test[:, 1], test[:, 2] + 1], axis=1
    ).astype(np.int32)
    return {"nodes": nodes, "edges": edges}, test32


def mutag_like_json(
    n_graphs: int = 188,
    n_node_labels: int = 7,
    n_pendants: int = 10,
    label_noise: float = 0.05,
    seed: int = 0,
) -> dict:
    """The graph-classification stand-in of MUTAG's size (188 graphs):
    class membership is purely relational. Both classes are 6-cycles over
    the node-label multiset {0,0,1,1,2,2} (the same degrees and label
    histogram); class 0 orders the labels 0,1,2,0,1,2 around the ring
    (every edge joins two different labels), class 1 0,0,1,1,2,2 (half
    the edges join equal labels). So a label-histogram readout is at
    chance and one message-passing round sees the signal. Pendant nodes
    with random labels hang off random ring nodes as noise, and
    `label_noise` flips that share of the graph labels."""
    rng = np.random.default_rng(seed)
    nodes, edges = [], []
    nid = 1
    for gi in range(n_graphs):
        cls = gi % 2
        shown = cls if rng.random() >= label_noise else 1 - cls
        core = list(range(nid, nid + 6))
        nid += 6
        core_pairs = [(core[k], core[(k + 1) % 6]) for k in range(6)]
        core_labels = [0, 1, 2, 0, 1, 2] if cls == 0 else [0, 0, 1, 1, 2, 2]
        n_pend = int(rng.integers(max(1, n_pendants - 3), n_pendants + 4))
        pend = list(range(nid, nid + n_pend))
        nid += n_pend
        pend_labels = rng.integers(0, n_node_labels, n_pend).tolist()
        for i, lab in zip(core + pend, core_labels + pend_labels):
            feat = np.zeros(n_node_labels, dtype=np.float32)
            feat[lab] = 1.0
            nodes.append({"id": i, "type": 0, "weight": 1.0, "features": [
                {"name": "feature", "type": "dense", "value": feat.tolist()},
                {"name": "graph_label", "type": "binary", "value": f"g{gi}_c{shown}"},
            ]})
        pairs = list(core_pairs)
        for p in pend:  # each pendant hangs off a random ring node
            pairs.append((p, core[int(rng.integers(6))]))
        for a, b in pairs:
            for s, d in ((a, b), (b, a)):
                edges.append({"src": s, "dst": d, "type": 0, "weight": 1.0, "features": []})
    return {"nodes": nodes, "edges": edges}


def cora_like_json(
    num_nodes: int = 2708,
    num_classes: int = 7,
    feature_dim: int = 1433,
    avg_degree: float = 3.9,
    homophily: float = 0.68,
    features_on: int = 18,
    word_sigma: float = 0.8,
    train_per_class: int = 20,
    val_n: int = 500,
    test_n: int = 1000,
    seed: int = 0,
) -> dict:
    """Citation-network stand-in calibrated to cora's GCN score.

    Each node's bag-of-words draws from its class's word distribution
    softmax(word_sigma * G[c]) over the shared vocabulary (G ~ N(0,1)), so
    classes overlap like real topics. word_sigma is the calibration knob:
    lower → more shared words → weaker features → bigger GCN-over-LR gap.
    """
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, num_classes, num_nodes)

    # citation-style degree heavy tail, truncated
    deg = np.clip(
        rng.lognormal(mean=np.log(avg_degree * 0.75), sigma=0.75, size=num_nodes),
        1,
        30,
    ).astype(np.int64)
    by_class = [np.nonzero(classes == c)[0] for c in range(num_classes)]
    seen = set()
    pairs = []
    for i in range(num_nodes):
        for _ in range(int(deg[i])):
            if rng.random() < homophily:
                j = int(rng.choice(by_class[classes[i]]))
            else:
                j = int(rng.integers(num_nodes))
            if j == i:
                continue
            key = (min(i, j), max(i, j))
            if key in seen:
                continue
            seen.add(key)
            pairs.append(key)

    # sparse bag-of-words from overlapping per-class word distributions
    logits = word_sigma * rng.normal(0, 1, (num_classes, feature_dim))
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    feat_rows = []
    for i in range(num_nodes):
        k = 1 + rng.poisson(features_on - 1)
        idx = rng.choice(feature_dim, size=k, p=probs[classes[i]])
        feat_rows.append(np.unique(idx))

    # split: 20/class train, then val/test from the remainder (shuffled)
    types = np.full(num_nodes, 3, dtype=np.int64)  # 3 = unused pool
    for c in range(num_classes):
        types[rng.permutation(by_class[c])[:train_per_class]] = 0
    rest = rng.permutation(np.nonzero(types == 3)[0])
    types[rest[:val_n]] = 1
    types[rest[val_n : val_n + test_n]] = 2

    feats = np.zeros((num_nodes, feature_dim), np.float32)
    for i in range(num_nodes):
        feats[i, feat_rows[i]] = 1.0
    labels = np.zeros((num_nodes, num_classes), np.float32)
    labels[np.arange(num_nodes), classes] = 1.0
    return _emit_node_class_json(feats, labels, types, pairs)


def _emit_node_class_json(feats, labels, types, pairs) -> dict:
    """Shared JSON emission for node-classification stand-ins: one dense
    `feature` + one dense `label` per node, 1-based ids, each dedup'd
    undirected pair emitted in both directions."""
    nodes = [
        {
            "id": i + 1,
            "type": int(types[i]),
            "weight": 1.0,
            "features": [
                {"name": "feature", "type": "dense",
                 "value": np.asarray(feats[i]).tolist()},
                {"name": "label", "type": "dense",
                 "value": np.asarray(labels[i]).tolist()},
            ],
        }
        for i in range(len(types))
    ]
    edges = [
        {"src": s + 1, "dst": d + 1, "type": 0, "weight": 1.0,
         "features": []}
        for i, j in pairs
        for s, d in ((i, j), (j, i))
    ]
    return {"nodes": nodes, "edges": edges}
