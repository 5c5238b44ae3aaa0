"""Device-side message-passing primitives
(counterpart: euler_tpu/ops/mp_ops.py:26-49).

Padding convention: dataflows route padded edges to valid-looking indices
and pass `mask`; masked rows contribute 0 to a sum.
"""

from __future__ import annotations

import torch


def gather(params: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """params[indices] along axis 0 (MPGather)."""
    return params.index_select(0, indices.reshape(-1).long()).reshape(
        indices.shape + params.shape[1:]
    )


def scatter_add(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum `data` rows into `num_segments` rows (MPScatterAdd); rows whose
    `mask` is False contribute nothing."""
    if mask is not None:
        shape = mask.shape + (1,) * (data.dim() - mask.dim())
        data = torch.where(mask.reshape(shape), data, torch.zeros_like(data))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)
