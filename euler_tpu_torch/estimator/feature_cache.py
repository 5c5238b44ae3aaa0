"""Device-resident node feature cache
(counterpart: euler_tpu/estimator/feature_cache.py:32-164).

The dense feature table lives on the device once, with a zero row 0 for
padding; batches carry int32 feature rows (the lean wire of the device
flows), and `hydrate(batch)` turns them back into dense per-hop features
next to the first layer. Quantization "f32" (exact) and "bf16" (half the
memory, one round-to-nearest-even per value) are ported; "int8",
`refresh_rows` and `ResidualFetchRing` are not yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.distributed.codec import page_dtype


def _is_rows(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() == 1 and not x.is_floating_point()


class DeviceFeatureCache:
    """Device copy of a graph's dense feature table, +1 zero padding row."""

    def __init__(
        self,
        graph,
        feature_names,
        dtype=torch.float32,
        sharding=None,
        stage_chunk_rows: int | None = None,
        quant: str | None = None,
        *,
        device=None,
    ):
        """The reference's parameters in its order. quant: "f32" | "bf16";
        defaults to EULER_TPU_PAGE_DTYPE, as in the JAX package. A
        non-f32 `dtype`, `sharding` and `stage_chunk_rows` are not ported
        yet. On the CUDA card unless device="cpu"."""
        if dtype is not torch.float32 or sharding is not None or stage_chunk_rows is not None:
            raise NotImplementedError(
                "DeviceFeatureCache(dtype=, sharding=, stage_chunk_rows=) is not ported yet"
            )
        self.device = resolve_device(device)
        self.feature_names = list(feature_names)
        host = graph.dense_feature_table(self.feature_names)
        self.dim = host.shape[1]
        table = np.concatenate([np.zeros((1, self.dim), np.float32), host], axis=0)
        self.quant = quant if quant is not None else page_dtype()
        if self.quant not in ("f32", "bf16"):
            raise ValueError(
                f"feature cache quant {self.quant!r} is not ported (f32, bf16)"
            )
        t = torch.from_numpy(np.ascontiguousarray(table, np.float32))
        if self.quant == "bf16":
            t = t.to(torch.bfloat16)
        self.table = t.to(self.device)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """int rows (0 = padding) → f32 [n, F]; bf16 tables widen here."""
        out = self.table.index_select(0, rows.reshape(-1)).reshape(rows.shape + (self.dim,))
        return out.float() if self.quant == "bf16" else out

    def hydrate(self, batch):
        """MiniBatch with rows-mode feature slots → dense feature slots;
        anything else passes through."""
        if not isinstance(batch, MiniBatch) or not batch.feats:
            return batch
        if not _is_rows(batch.feats[0]):
            return batch
        return dataclasses.replace(batch, feats=tuple(self.gather(r) for r in batch.feats))

    def hydrate_args(self, args: tuple) -> tuple:
        return tuple(self.hydrate(a) for a in args)
