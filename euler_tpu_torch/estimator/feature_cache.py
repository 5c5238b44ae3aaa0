"""Device-resident node feature cache
(counterpart: euler_tpu/estimator/feature_cache.py:32-164).

The dense feature table lives on the device once, with a zero row 0 for
padding; batches carry int32 feature rows (the lean wire of the device
flows), and `hydrate(batch)` turns them back into dense per-hop features
next to the first layer. Pages are "f32" (exact), "bf16" (half the
memory, one round-to-nearest-even per value) or "int8" (a quarter, with
a per-row affine scale / zero point), dequantized in `gather`.
`refresh_rows` and `ResidualFetchRing` wait for the graph tier (ROADMAP
queue 1 item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.distributed.codec import page_dtype, quantize


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
        """The reference's parameters in its order. quant: "f32" | "bf16" |
        "int8", by default EULER_TPU_PAGE_DTYPE; a `dtype` other than f32
        wins over it (the caller already chose a representation).
        stage_chunk_rows: stage the table in row chunks of that many, one
        transfer each, then join them on the device (the same table as
        one transfer). `sharding` is not ported yet (ROADMAP queue 1 item
        6). On the CUDA card unless device="cpu"."""
        if sharding is not None:
            raise NotImplementedError(
                "DeviceFeatureCache(sharding=) is not ported yet (ROADMAP queue 1 item 6)"
            )
        self.device = resolve_device(device)
        self.feature_names = list(feature_names)
        host = graph.dense_feature_table(self.feature_names)
        self.dim = host.shape[1]
        table = np.concatenate([np.zeros((1, self.dim), np.float32), host], axis=0)
        if dtype is torch.float32:
            self.quant = quant if quant is not None else page_dtype()
        else:
            self.quant = "f32"
        if self.quant not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown page dtype {self.quant!r}")
        if self.quant == "int8":
            q, scale, zero = quantize("int8", table)
            # padding row 0 dequantizes to exact zeros: q = 0, zero = 0
            zero[0] = 0.0
            self._scale = torch.from_numpy(scale).to(self.device)
            self._zero = torch.from_numpy(zero).to(self.device)
            t = torch.from_numpy(q)
        elif self.quant == "bf16":
            t = quantize("bf16", table)[0]
        else:
            t = torch.from_numpy(np.ascontiguousarray(table, np.float32)).to(dtype)
        if stage_chunk_rows and len(t) > stage_chunk_rows:
            self.table = torch.cat([t[lo : lo + stage_chunk_rows].to(self.device)
                                    for lo in range(0, len(t), stage_chunk_rows)])
        else:
            self.table = t.to(self.device)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """int rows (0 = padding) → [*rows.shape, F], f32 for quantized
        pages: bf16 widens, int8 is q · scale + zero of its row (plain
        torch, as the JAX package leaves it to XLA)."""
        flat = rows.reshape(-1)
        out = self.table.index_select(0, flat)
        if self.quant == "int8":
            out = (out.float() * self._scale.index_select(0, flat)[:, None]
                   + self._zero.index_select(0, flat)[:, None])
        elif self.quant == "bf16":
            out = out.float()
        return out.reshape(rows.shape + (self.dim,))

    def _patch(self, rows: torch.Tensor, vals) -> None:
        """Write f32 rows `vals` at table rows `rows` (the +1 padding
        offset already applied), quantized to the table's representation:
        the write `refresh_rows` makes."""
        rows = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        if self.quant == "int8":
            q, scale, zero = quantize("int8", np.asarray(vals, np.float32))
            self.table[rows] = torch.from_numpy(q).to(self.device)
            self._scale[rows] = torch.from_numpy(scale).to(self.device)
            self._zero[rows] = torch.from_numpy(zero).to(self.device)
            return
        vals = torch.as_tensor(np.asarray(vals, np.float32))
        self.table[rows] = vals.to(self.table.dtype).to(self.device)

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
