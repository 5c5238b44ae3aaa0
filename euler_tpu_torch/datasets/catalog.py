"""Dataset catalog (counterpart: euler_tpu/datasets/catalog.py): cora,
citeseer, pubmed (Planetoid), mutag (TU graph classification) and fb15k
/ fb15k237 / wn18 (KG triples). The other datasets of the JAX catalog
(ppi, reddit, ml_1m) are not ported yet (ROADMAP queue 1 item 4) and
raise NotImplementedError.
"""

from __future__ import annotations

import os

import numpy as np

from euler_tpu_torch.datasets.base import Dataset, _planted_partition_json


class PlanetoidDataset(Dataset):
    """cora / citeseer / pubmed from the classic Planetoid pickles."""

    sizes = {
        "cora": (2708, 1433, 7),
        "citeseer": (3327, 3703, 6),
        "pubmed": (19717, 500, 3),
    }

    def __init__(self, name: str, **kw):
        self.name = name
        n, f, c = self.sizes[name]
        self.num_nodes, self.feature_dim, self.num_classes = n, f, c
        super().__init__(**kw)

    def raw_files(self):
        parts = ["x", "y", "tx", "ty", "allx", "ally", "graph", "test.index"]
        return [f"ind.{self.name}.{p}" for p in parts]

    def build_json(self) -> dict:
        import pickle

        def load(part):
            path = os.path.join(self.root, f"ind.{self.name}.{part}")
            if part == "test.index":
                return np.loadtxt(path, dtype=np.int64)
            with open(path, "rb") as f:
                return pickle.load(f, encoding="latin1")

        x, y, tx, ty, allx, ally = (
            load(p) for p in ("x", "y", "tx", "ty", "allx", "ally")
        )
        graph = load("graph")
        test_idx = load("test.index")
        tx_dense = np.asarray(tx.todense())
        ty_dense = np.asarray(ty)
        sorted_test = np.sort(test_idx)
        lo, hi = int(test_idx.min()), int(test_idx.max())
        if hi - lo + 1 > len(test_idx):
            # citeseer: test.index has gaps (isolated nodes) — extend the
            # test block over the full contiguous range, zero-filling
            tx_ext = np.zeros((hi - lo + 1, tx_dense.shape[1]))
            ty_ext = np.zeros((hi - lo + 1, ty_dense.shape[1]))
            tx_ext[sorted_test - lo] = tx_dense
            ty_ext[sorted_test - lo] = ty_dense
            tx_dense, ty_dense = tx_ext, ty_ext
        feats = np.vstack([np.asarray(allx.todense()), tx_dense])
        labels = np.vstack([np.asarray(ally), ty_dense])
        # standard fixup: the test block arrives permuted by test.index
        feats[test_idx] = feats[sorted_test]
        labels[test_idx] = labels[sorted_test]
        n = feats.shape[0]
        train_n = len(np.asarray(y))
        val_n = 500
        types = np.full(n, 2)
        types[:train_n] = 0
        types[train_n : train_n + val_n] = 1
        nodes = [
            {
                "id": i + 1,
                "type": int(types[i]),
                "weight": 1.0,
                "features": [
                    {"name": "feature", "type": "dense", "value": feats[i].tolist()},
                    {"name": "label", "type": "dense", "value": labels[i].tolist()},
                ],
            }
            for i in range(n)
        ]
        edges = [
            {"src": i + 1, "dst": j + 1, "type": 0, "weight": 1.0, "features": []}
            for i, nbrs in graph.items()
            for j in nbrs
            if i < n and j < n
        ]
        return {"nodes": nodes, "edges": edges}

    def synthetic_json(self, seed: int = 0) -> dict:
        return _planted_partition_json(
            min(self.num_nodes, 600),
            min(self.feature_dim, 64),
            self.num_classes,
            seed=seed,
        )


class KGDataset(Dataset):
    """fb15k / fb15k237 / wn18 triples (train/valid/test .txt TSV)."""

    def __init__(self, name: str = "fb15k", **kw):
        self.name = name
        super().__init__(**kw)
        self.entity_map: dict[str, int] = {}
        self.relation_map: dict[str, int] = {}

    def raw_files(self):
        return ["train.txt", "valid.txt", "test.txt"]

    def _triples(self, split: str):
        path = os.path.join(self.root, f"{split}.txt")
        out = []
        with open(path) as f:
            for line in f:
                h, r, t = line.rstrip("\n").split("\t")
                out.append((h, r, t))
        return out

    def _build_maps(self):
        """Deterministic entity/relation id maps derived from train.txt."""
        ents, rels = {}, {}
        for h, r, t in self._triples("train"):
            ents.setdefault(h, len(ents) + 1)
            ents.setdefault(t, len(ents) + 1)
            rels.setdefault(r, len(rels))
        self.entity_map, self.relation_map = ents, rels

    def build_json(self) -> dict:
        self._build_maps()
        ents, rels = self.entity_map, self.relation_map
        train = self._triples("train")
        nodes = [
            {"id": i, "type": 0, "weight": 1.0, "features": []}
            for i in ents.values()
        ]
        edges = [
            {
                "src": ents[h],
                "dst": ents[t],
                "type": rels[r],
                "weight": 1.0,
                "features": [],
            }
            for h, r, t in train
        ]
        return {"nodes": nodes, "edges": edges}

    def eval_triples(self, split: str = "test") -> np.ndarray:
        """int32 [M, 3] (h, r, t) restricted to known entities/relations."""
        if not self.entity_map:
            self._build_maps()
        out = []
        for h, r, t in self._triples(split):
            if h in self.entity_map and t in self.entity_map and r in self.relation_map:
                out.append(
                    (self.entity_map[h], self.relation_map[r], self.entity_map[t])
                )
        return np.asarray(out, dtype=np.int32)

    def synthetic_json(self, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        n_ent, n_rel, n_tri = 200, 6, 2000
        nodes = [
            {"id": i + 1, "type": 0, "weight": 1.0, "features": []}
            for i in range(n_ent)
        ]
        edges = [
            {
                "src": int(rng.integers(1, n_ent + 1)),
                "dst": int(rng.integers(1, n_ent + 1)),
                "type": int(rng.integers(0, n_rel)),
                "weight": 1.0,
                "features": [],
            }
            for _ in range(n_tri)
        ]
        return {"nodes": nodes, "edges": edges}


class TUDataset(Dataset):
    """mutag-style graph classification from the TU files (DS_A,
    DS_graph_indicator, DS_graph_labels, DS_node_labels): one-hot node
    labels as `feature`, each node's graph label `g<graph>_c<class>`."""

    def __init__(self, name: str = "mutag", **kw):
        self.name = name
        self.feature_dim = 8
        self.num_classes = 2
        super().__init__(**kw)

    def raw_files(self):
        up = self.name.upper()
        return [f"{up}_A.txt", f"{up}_graph_indicator.txt", f"{up}_graph_labels.txt",
                f"{up}_node_labels.txt"]

    def build_json(self) -> dict:
        up = self.name.upper()

        def load(part, **kw):
            return np.loadtxt(os.path.join(self.root, f"{up}_{part}.txt"), dtype=np.int64, **kw)

        edges_raw = load("A", delimiter=",")
        gi, gl, nl = load("graph_indicator"), load("graph_labels"), load("node_labels")
        eye = np.eye(int(nl.max()) + 1)
        nodes = [
            {"id": i + 1, "type": 0, "weight": 1.0, "features": [
                {"name": "feature", "type": "dense", "value": eye[nl[i]].tolist()},
                {"name": "graph_label", "type": "binary",
                 "value": f"g{gi[i]}_c{gl[gi[i] - 1]}"},
            ]}
            for i in range(len(gi))
        ]
        edges = [{"src": int(s), "dst": int(d), "type": 0, "weight": 1.0, "features": []}
                 for s, d in edges_raw]
        return {"nodes": nodes, "edges": edges}

    def synthetic_json(self, seed: int = 0) -> dict:
        """24 graphs of 5-8 nodes, alternating classes: class 0 a clique of
        features around +2, class 1 a path of features around -2."""
        rng = np.random.default_rng(seed)
        nodes, edges = [], []
        nid = 1
        for gidx in range(24):
            cls = gidx % 2
            size = int(rng.integers(5, 9))
            ids = list(range(nid, nid + size))
            nid += size
            for i in ids:
                nodes.append({"id": i, "type": 0, "weight": 1.0, "features": [
                    {"name": "feature", "type": "dense",
                     "value": rng.normal(2.0 * (1 - 2 * cls), 1, 8).tolist()},
                    {"name": "graph_label", "type": "binary", "value": f"g{gidx}_c{cls}"},
                ]})
            for i in ids:
                for j in ids:
                    if i != j and (cls == 0 or abs(i - j) <= 1):
                        edges.append({"src": i, "dst": j, "type": 0, "weight": 1.0,
                                      "features": []})
        return {"nodes": nodes, "edges": edges}


DATASETS = {
    "cora": lambda **kw: PlanetoidDataset("cora", **kw),
    "citeseer": lambda **kw: PlanetoidDataset("citeseer", **kw),
    "pubmed": lambda **kw: PlanetoidDataset("pubmed", **kw),
    "mutag": lambda **kw: TUDataset("mutag", **kw),
    "fb15k": lambda **kw: KGDataset("fb15k", **kw),
    "fb15k237": lambda **kw: KGDataset("fb15k237", **kw),
    "wn18": lambda **kw: KGDataset("wn18", **kw),
}
# the JAX catalog's other names, which the port does not load yet
NOT_PORTED = ("ppi", "reddit", "ml_1m")


def get_dataset(name: str, **kw) -> Dataset:
    """The dataset of that name; the JAX catalog's names not ported yet
    raise NotImplementedError naming their ROADMAP item."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP queue 1 item 4); "
            f"the port loads {sorted(DATASETS)}"
        )
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](**kw)
