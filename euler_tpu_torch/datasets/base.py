"""Dataset pipeline (counterpart: euler_tpu/datasets/base.py).

Each dataset resolves through three stages: raw files (pre-placed in the
cache dir) → graph.json dict → converted tensor-dir shards (cached) →
Graph. Nothing is downloaded: `download()` only checks the cache and
raises with instructions when raw files are missing; `synthetic=True`
generates the JAX package's offline stand-in (the same graph for the
same seed), so every pipeline stays runnable offline.
"""

from __future__ import annotations

import os

import numpy as np

from euler_tpu_torch.graph import Graph
from euler_tpu_torch.graph.builder import convert_json

CACHE_ENV = "EULER_TPU_DATA"


def cache_dir() -> str:
    return os.environ.get(
        CACHE_ENV, os.path.expanduser("~/.cache/euler_tpu_data")
    )


class Dataset:
    name: str = "base"
    urls: list[str] = []
    num_classes: int = 2
    feature_dim: int = 8
    node_type_train = 0  # convention: type 0 = train, 1 = val, 2 = test

    def __init__(self, root: str | None = None, num_partitions: int = 1):
        self.root = root or os.path.join(cache_dir(), self.name)
        self.num_partitions = num_partitions

    # -- to be implemented per dataset -----------------------------------

    def raw_files(self) -> list[str]:
        return []

    def build_json(self) -> dict:
        """Parse raw files → graph.json dict."""
        raise NotImplementedError

    def synthetic_json(self, seed: int = 0) -> dict:
        """Offline stand-in with the same schema/feature dims."""
        raise NotImplementedError

    # -- pipeline ---------------------------------------------------------

    def raw_present(self) -> bool:
        files = self.raw_files()
        return bool(files) and all(
            os.path.exists(os.path.join(self.root, f)) for f in files
        )

    def download(self):
        if self.raw_present():
            return
        raise FileNotFoundError(
            f"dataset {self.name!r}: raw files missing under {self.root} "
            f"(no network egress here). Place {self.raw_files()} there, or "
            f"load with synthetic=True for an offline stand-in."
        )

    def load_graph(self, synthetic: bool = False) -> Graph:
        tag = "synthetic" if synthetic else "real"
        out = os.path.join(self.root, f"converted_{tag}_p{self.num_partitions}")
        if not os.path.exists(os.path.join(out, "euler.meta.json")):
            if synthetic:
                data = self.synthetic_json()
            else:
                self.download()
                data = self.build_json()
            os.makedirs(out, exist_ok=True)
            convert_json(data, out, self.num_partitions, name=self.name)
        return Graph.load(out)

    def splits(self, graph: Graph) -> dict[str, np.ndarray]:
        """train/val/test node ids by node type (0/1/2 convention)."""
        out = {}
        for name, t in (("train", 0), ("val", 1), ("test", 2)):
            ids = []
            for sh in graph.shards:
                sel = np.asarray(sh.node_types) == t
                ids.append(np.asarray(sh.node_ids)[sel])
            out[name] = np.sort(np.concatenate(ids))
        return out


def _planted_partition_json(
    num_nodes: int,
    feature_dim: int,
    num_classes: int,
    avg_degree: int = 4,
    seed: int = 0,
    label_name: str = "label",
    feat_name: str = "feature",
    train_frac: float = 0.6,
    val_frac: float = 0.2,
) -> dict:
    """Cluster-separable citation-style stand-in graph."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, num_classes, num_nodes)
    centers = rng.normal(0, 2.0, (num_classes, feature_dim))
    split = rng.random(num_nodes)
    nodes = []
    for i in range(num_nodes):
        t = 0 if split[i] < train_frac else (1 if split[i] < train_frac + val_frac else 2)
        feat = centers[classes[i]] + rng.normal(0, 1.0, feature_dim)
        label = np.zeros(num_classes)
        label[classes[i]] = 1.0
        nodes.append(
            {
                "id": i + 1,
                "type": t,
                "weight": 1.0,
                "features": [
                    {"name": feat_name, "type": "dense", "value": feat.tolist()},
                    {"name": label_name, "type": "dense", "value": label.tolist()},
                ],
            }
        )
    edges = []
    for i in range(num_nodes):
        same = np.nonzero(classes == classes[i])[0]
        for j in rng.choice(same, size=min(avg_degree, len(same)), replace=False):
            if j != i:
                edges.append(
                    {
                        "src": i + 1,
                        "dst": int(j) + 1,
                        "type": 0,
                        "weight": 1.0,
                        "features": [],
                    }
                )
    return {"nodes": nodes, "edges": edges}
