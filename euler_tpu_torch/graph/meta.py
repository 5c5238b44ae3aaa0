"""Graph metadata: feature and type tables shared by all shards
(counterpart: euler_tpu/graph/meta.py; the same `euler.meta.json`)."""

from __future__ import annotations

import dataclasses
import json
import os

DENSE = "dense"
SPARSE = "sparse"
BINARY = "binary"


@dataclasses.dataclass
class FeatureSpec:
    name: str
    kind: str  # dense | sparse | binary
    fid: int  # id within its kind
    dim: int  # dense: feature width; sparse/binary: max observed length

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GraphMeta:
    name: str = "graph"
    num_partitions: int = 1
    num_node_types: int = 0
    num_edge_types: int = 0
    node_features: dict[str, FeatureSpec] = dataclasses.field(default_factory=dict)
    edge_features: dict[str, FeatureSpec] = dataclasses.field(default_factory=dict)
    # per-partition, per-type weight sums: [P][num_types]
    node_weight_sums: list[list[float]] = dataclasses.field(default_factory=list)
    edge_weight_sums: list[list[float]] = dataclasses.field(default_factory=list)
    graph_labels: list[str] = dataclasses.field(default_factory=list)
    node_type_names: list[str] = dataclasses.field(default_factory=list)
    edge_type_names: list[str] = dataclasses.field(default_factory=list)

    def feature_spec(self, name: str, node: bool = True) -> FeatureSpec:
        table = self.node_features if node else self.edge_features
        if name not in table:
            kind = "node" if node else "edge"
            raise KeyError(f"unknown {kind} feature {name!r}; have {sorted(table)}")
        return table[name]

    def node_type_id(self, t) -> int:
        return _type_id(t, self.node_type_names)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["node_features"] = {k: v.to_dict() for k, v in self.node_features.items()}
        d["edge_features"] = {k: v.to_dict() for k, v in self.edge_features.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "GraphMeta":
        d = dict(d)
        d["node_features"] = {
            k: FeatureSpec(**v) for k, v in d.get("node_features", {}).items()
        }
        d["edge_features"] = {
            k: FeatureSpec(**v) for k, v in d.get("edge_features", {}).items()
        }
        return cls(**d)

    def save(self, directory: str) -> None:
        # tmp + fsync + atomic rename: a crash mid-save leaves the previous
        # meta readable, never a torn JSON
        final = os.path.join(directory, "euler.meta.json")
        tmp = f"{final}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    @classmethod
    def load(cls, directory: str) -> "GraphMeta":
        with open(os.path.join(directory, "euler.meta.json")) as f:
            return cls.from_dict(json.load(f))


def load(directory: str) -> GraphMeta:
    """The graph dir's `euler.meta.json` as a GraphMeta."""
    return GraphMeta.load(directory)


def _type_id(t, names: list[str]) -> int:
    """Resolve a type given as int or registered name."""
    if isinstance(t, str):
        if t in names:
            return names.index(t)
        raise KeyError(f"unknown type name {t!r}; have {names}")
    return int(t)
