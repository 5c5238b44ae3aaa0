"""Host-side history embedding table for scalable (1-hop) training
(counterpart: euler_tpu/nn/history.py; the port's own copy, numpy only).

Every node's last-known activation lives in a host numpy table; a train
step reads the frontier's rows from it and refreshes the roots' rows with
a moving average. The table stays on the host, as in the JAX package:
numpy's fancy assignment keeps the last write of a repeated id, which an
`index_put_` on a CUDA tensor does not promise.
"""

from __future__ import annotations

import numpy as np


class HistoryTable:
    def __init__(self, num_nodes: int, dim: int, momentum: float = 0.9):
        self.table = np.zeros((num_nodes + 1, dim), dtype=np.float32)
        self.momentum = momentum
        self.num_nodes = num_nodes

    def _rows(self, ids: np.ndarray) -> np.ndarray:
        return np.clip(ids.astype(np.int64), 0, self.num_nodes)

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        return self.table[self._rows(ids)]

    def update(self, ids: np.ndarray, values: np.ndarray) -> None:
        rows = self._rows(ids)
        m = self.momentum
        self.table[rows] = m * self.table[rows] + (1 - m) * np.asarray(values)
