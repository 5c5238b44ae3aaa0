"""graph.json → partitioned columnar shards, numpy only
(counterpart: euler_tpu/graph/builder.py; the same arrays for the same
input, held by tests/test_torch_kg.py).

Input schema: nodes have {id, type, weight, features:[{name, type:
dense|sparse|binary, value}]}, edges have {src, dst, type, weight,
features}. Nodes are partitioned by `id % P`, edges by `src % P`, and an
in-edge adjacency partitioned by `dst % P` is built as well. The arrays
of a shard are the ones `graph/store.py` reads (node_ids sorted; per
edge type an out- and an in-adjacency CSR; the flat edge columns;
node and edge feature columns; nodes grouped by graph label).
"""

from __future__ import annotations

import json
import os

import numpy as np

from euler_tpu_torch.graph import format as tformat
from euler_tpu_torch.graph.meta import BINARY, DENSE, SPARSE, FeatureSpec, GraphMeta

GRAPH_LABEL_FEATURE = "graph_label"


def _collect_feature_specs(items: list[dict]) -> dict[str, FeatureSpec]:
    """Scan records and assign deterministic fids per kind (sorted by name)."""
    kinds: dict[str, str] = {}
    dims: dict[str, int] = {}
    for it in items:
        for feat in it.get("features", ()):
            name, kind = feat["name"], feat["type"]
            if kinds.setdefault(name, kind) != kind:
                raise ValueError(f"feature {name!r} has inconsistent kinds")
            v = feat["value"]
            length = len(v) if kind != BINARY else len(str(v).encode())
            dims[name] = max(dims.get(name, 0), length)
    specs: dict[str, FeatureSpec] = {}
    for kind in (DENSE, SPARSE, BINARY):
        names = sorted(n for n, k in kinds.items() if k == kind)
        for fid, name in enumerate(names):
            specs[name] = FeatureSpec(name=name, kind=kind, fid=fid, dim=dims[name])
    return specs


def _feature_arrays(
    items: list[dict], specs: dict[str, FeatureSpec], prefix: str
) -> dict[str, np.ndarray]:
    """Build columnar feature arrays for `items` (already one partition)."""
    n = len(items)
    out: dict[str, np.ndarray] = {}
    by_fid = {(s.kind, s.fid): s for s in specs.values()}
    # index features per item for O(1) lookup
    per_item = [
        {f["name"]: f["value"] for f in it.get("features", ())} for it in items
    ]
    for (kind, fid), spec in sorted(by_fid.items()):
        if kind == DENSE:
            arr = np.zeros((n, spec.dim), dtype=np.float32)
            for i, feats in enumerate(per_item):
                v = feats.get(spec.name)
                if v is not None:
                    arr[i, : len(v)] = v
            out[f"{prefix}_dense_{fid}"] = arr
        elif kind == SPARSE:
            vals, indptr = [], np.zeros(n + 1, dtype=np.int64)
            for i, feats in enumerate(per_item):
                v = feats.get(spec.name) or []
                vals.extend(int(x) for x in v)
                indptr[i + 1] = len(vals)
            out[f"{prefix}_sparse_{fid}_indptr"] = indptr
            out[f"{prefix}_sparse_{fid}_values"] = np.asarray(vals, dtype=np.uint64)
        else:  # binary
            blob, indptr = bytearray(), np.zeros(n + 1, dtype=np.int64)
            for i, feats in enumerate(per_item):
                v = feats.get(spec.name)
                if v is not None:
                    blob.extend(str(v).encode())
                indptr[i + 1] = len(blob)
            out[f"{prefix}_bin_{fid}_indptr"] = indptr
            out[f"{prefix}_bin_{fid}_values"] = np.frombuffer(
                bytes(blob), dtype=np.uint8
            )
    return out


def _csr_adjacency(
    node_ids: np.ndarray,
    key_ids: np.ndarray,
    other_ids: np.ndarray,
    types: np.ndarray,
    weights: np.ndarray,
    eidx: np.ndarray,
    num_edge_types: int,
    tag: str,
) -> dict[str, np.ndarray]:
    """Group edges (columnar) by (key node row, type) into per-type CSRs.

    One vectorized pass: row lookup via searchsorted, then a single
    lexsort by (type, row) emits every per-type CSR slice at once.
    """
    n = len(node_ids)
    out: dict[str, np.ndarray] = {}
    if n == 0 or len(key_ids) == 0:
        for t in range(num_edge_types):
            out[f"{tag}_{t}_indptr"] = np.zeros(n + 1, dtype=np.int64)
            out[f"{tag}_{t}_dst"] = np.zeros(0, dtype=np.uint64)
            out[f"{tag}_{t}_w"] = np.zeros(0, dtype=np.float32)
            out[f"{tag}_{t}_eidx"] = np.zeros(0, dtype=np.int64)
        return out
    pos = np.clip(np.searchsorted(node_ids, key_ids), 0, n - 1)
    rows = np.where(node_ids[pos] == key_ids, pos, -1)
    keep = rows >= 0
    rows, other_ids, types = rows[keep], other_ids[keep], types[keep]
    weights, eidx = weights[keep], eidx[keep]
    perm = np.lexsort((rows, types))
    rows, other_ids = rows[perm], other_ids[perm]
    types, weights, eidx = types[perm], weights[perm], eidx[perm]
    starts = np.searchsorted(types, np.arange(num_edge_types + 1))
    for t in range(num_edge_types):
        s, e = starts[t], starts[t + 1]
        r = rows[s:e]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        out[f"{tag}_{t}_indptr"] = np.cumsum(indptr)
        out[f"{tag}_{t}_dst"] = other_ids[s:e].astype(np.uint64)
        out[f"{tag}_{t}_w"] = weights[s:e].astype(np.float32)
        out[f"{tag}_{t}_eidx"] = eidx[s:e].astype(np.int64)
    return out


def build_partition_arrays(
    nodes: list[dict],
    edges: list[dict],
    in_edges: list[dict],
    node_specs: dict[str, FeatureSpec],
    edge_specs: dict[str, FeatureSpec],
    num_edge_types: int,
    graph_labels: list[str],
) -> dict[str, np.ndarray]:
    """Arrays for one shard. `edges` have src here; `in_edges` have dst here."""
    nodes = sorted(nodes, key=lambda x: int(x["id"]))
    node_ids = np.asarray([int(x["id"]) for x in nodes], dtype=np.uint64)
    arrays: dict[str, np.ndarray] = {
        "node_ids": node_ids,
        "node_types": np.asarray([int(x["type"]) for x in nodes], dtype=np.int32),
        "node_weights": np.asarray(
            [float(x.get("weight", 1.0)) for x in nodes], dtype=np.float32
        ),
        "edge_src": np.asarray([int(e["src"]) for e in edges], dtype=np.uint64),
        "edge_dst": np.asarray([int(e["dst"]) for e in edges], dtype=np.uint64),
        "edge_types": np.asarray([int(e["type"]) for e in edges], dtype=np.int32),
        "edge_weights": np.asarray(
            [float(e.get("weight", 1.0)) for e in edges], dtype=np.float32
        ),
    }
    e_src = arrays["edge_src"]
    e_dst = arrays["edge_dst"]
    e_tt = arrays["edge_types"]
    e_w = arrays["edge_weights"]
    arrays.update(
        _csr_adjacency(
            node_ids, e_src, e_dst, e_tt, e_w,
            np.arange(len(edges), dtype=np.int64), num_edge_types, "adj",
        )
    )
    # in-edges live on dst's shard but their feature rows live on src's shard:
    # eidx is only valid when the edge is also locally owned, else -1
    # (consumers resolve off-shard edge features via (src,dst,type) triples).
    local_row = {id(e): i for i, e in enumerate(edges)}
    in_eidx = np.asarray(
        [local_row.get(id(e), -1) for e in in_edges], dtype=np.int64
    )
    arrays.update(
        _csr_adjacency(
            node_ids,
            np.asarray([int(e["dst"]) for e in in_edges], dtype=np.uint64),
            np.asarray([int(e["src"]) for e in in_edges], dtype=np.uint64),
            np.asarray([int(e["type"]) for e in in_edges], dtype=np.int32),
            np.asarray([float(e.get("weight", 1.0)) for e in in_edges], dtype=np.float32),
            in_eidx,
            num_edge_types,
            "inadj",
        )
    )
    arrays.update(_feature_arrays(nodes, node_specs, "nf"))
    arrays.update(_feature_arrays(edges, edge_specs, "ef"))

    # graph-label grouping (whole-graph / graph-classification path,
    # sample_ops.py:235-237 parity)
    label_nodes: list[list[int]] = [[] for _ in graph_labels]
    label_of = {lab: i for i, lab in enumerate(graph_labels)}
    for nd in nodes:
        for f in nd.get("features", ()):
            if f["name"] == GRAPH_LABEL_FEATURE and f["type"] == BINARY:
                li = label_of.get(str(f["value"]))
                if li is not None:
                    label_nodes[li].append(int(nd["id"]))
    indptr = np.zeros(len(graph_labels) + 1, dtype=np.int64)
    flat: list[int] = []
    for i, ns in enumerate(label_nodes):
        flat.extend(sorted(ns))
        indptr[i + 1] = len(flat)
    arrays["glabel_indptr"] = indptr
    arrays["glabel_nodes"] = np.asarray(flat, dtype=np.uint64)
    return arrays


def build_from_json(
    graph_json: str | dict, num_partitions: int = 1, name: str = "graph"
) -> tuple[GraphMeta, list[dict[str, np.ndarray]]]:
    """Parse graph.json (path or dict) → (meta, per-partition array dicts)."""
    if isinstance(graph_json, str):
        with open(graph_json) as f:
            data = json.load(f)
    else:
        data = graph_json
    nodes, edges = data["nodes"], data["edges"]
    node_specs = _collect_feature_specs(nodes)
    edge_specs = _collect_feature_specs(edges)
    num_node_types = 1 + max((int(n["type"]) for n in nodes), default=-1)
    num_edge_types = 1 + max((int(e["type"]) for e in edges), default=-1)

    labels = sorted(
        {
            str(f["value"])
            for nd in nodes
            for f in nd.get("features", ())
            if f["name"] == GRAPH_LABEL_FEATURE and f["type"] == BINARY
        }
    )

    parts_nodes: list[list[dict]] = [[] for _ in range(num_partitions)]
    parts_edges: list[list[dict]] = [[] for _ in range(num_partitions)]
    parts_in_edges: list[list[dict]] = [[] for _ in range(num_partitions)]
    for nd in nodes:
        parts_nodes[int(nd["id"]) % num_partitions].append(nd)
    for e in edges:
        parts_edges[int(e["src"]) % num_partitions].append(e)
        parts_in_edges[int(e["dst"]) % num_partitions].append(e)

    meta = GraphMeta(
        name=name,
        num_partitions=num_partitions,
        num_node_types=num_node_types,
        num_edge_types=num_edge_types,
        node_features=node_specs,
        edge_features=edge_specs,
        graph_labels=labels,
    )
    shards = []
    for p in range(num_partitions):
        arrays = build_partition_arrays(
            parts_nodes[p],
            parts_edges[p],
            parts_in_edges[p],
            node_specs,
            edge_specs,
            num_edge_types,
            labels,
        )
        nw = np.zeros(num_node_types, dtype=np.float64)
        np.add.at(nw, arrays["node_types"], arrays["node_weights"].astype(np.float64))
        ew = np.zeros(num_edge_types, dtype=np.float64)
        np.add.at(ew, arrays["edge_types"], arrays["edge_weights"].astype(np.float64))
        meta.node_weight_sums.append(nw.tolist())
        meta.edge_weight_sums.append(ew.tolist())
        shards.append(arrays)
    return meta, shards


def convert_json(
    graph_json: str | dict,
    out_dir: str,
    num_partitions: int = 1,
    name: str = "graph",
) -> GraphMeta:
    """graph.json → on-disk tensor dirs: out_dir/part_{p}/ + euler.meta.json."""
    meta, shards = build_from_json(graph_json, num_partitions, name)
    os.makedirs(out_dir, exist_ok=True)
    for p, arrays in enumerate(shards):
        tformat.write_arrays(os.path.join(out_dir, f"part_{p}"), arrays)
    meta.save(out_dir)
    return meta
