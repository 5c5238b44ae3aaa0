"""Device-side message-passing primitives
(counterpart: euler_tpu/ops/mp_ops.py:26-145).

Padding convention: dataflows route padded edges to valid-looking indices
and pass `mask`; masked rows contribute the reduction's identity (0 for
add and mean, the dtype's lowest finite value for max, probability 0 for
softmax).

Gradients follow the JAX package: gather and scatter_add are each
other's adjoints, and scatter_max splits a segment's gradient equally
among the rows that tie for its max (mp_ops.py:76-85).
"""

from __future__ import annotations

import torch


def gather(params: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """params[indices] along axis 0 (MPGather)."""
    return params.index_select(0, indices.reshape(-1).long()).reshape(
        indices.shape + params.shape[1:]
    )


def _masked(data: torch.Tensor, mask: torch.Tensor | None, fill) -> torch.Tensor:
    if mask is None:
        return data
    shape = mask.shape + (1,) * (data.dim() - mask.dim())
    return torch.where(mask.reshape(shape), data, fill)


def scatter_add(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum `data` rows into `num_segments` rows (MPScatterAdd); rows whose
    `mask` is False contribute nothing."""
    data = _masked(data, mask, 0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def scatter_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment mean; empty segments give 0."""
    total = scatter_add(data, segment_ids, num_segments, mask)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    count = scatter_add(ones, segment_ids, num_segments, mask).clamp_min(1)
    return total / count.reshape((num_segments,) + (1,) * (data.dim() - 1))


def _segment_max_raw(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """jax.ops.segment_max: an empty segment holds -inf."""
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


class _SegmentMax(torch.autograd.Function):
    """Segment max whose backward gives each segment's gradient in equal
    shares to the rows equal to its max (mp_ops.py:76-85)."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        out = _segment_max_raw(data, segment_ids, num_segments)
        ctx.save_for_backward(data, segment_ids, out)
        ctx.num_segments = num_segments
        return out

    @staticmethod
    def backward(ctx, g):
        data, segment_ids, out = ctx.saved_tensors
        ties = (data == gather(out, segment_ids)).to(data.dtype)
        counts = scatter_add(ties, segment_ids, ctx.num_segments).clamp_min(1)
        return ties * gather(g / counts, segment_ids), None, None


def scatter_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    empty_value: float = 0.0,
) -> torch.Tensor:
    """Segment max (MPScatterMax); ties split the gradient equally, and
    an empty segment gives `empty_value`."""
    neg = torch.finfo(data.dtype).min
    out = _SegmentMax.apply(_masked(data, mask, neg), segment_ids, num_segments)
    # an empty segment holds -inf or the mask's fill, both <= finfo.min
    return torch.where(out <= neg, empty_value, out)


def scatter_softmax(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Each row's softmax probability within its segment, shaped like
    `data`; masked rows get 0. Masked rows are filled with the dtype's
    lowest finite value, an empty segment's max is 0, and the
    denominator is at least the dtype's smallest normal number."""
    finfo = torch.finfo(data.dtype)
    filled = _masked(data, mask, finfo.min)
    seg_max = _SegmentMax.apply(filled, segment_ids, num_segments)
    seg_max = torch.where(seg_max <= finfo.min, 0.0, seg_max)
    expd = torch.exp(filled - gather(seg_max, segment_ids))
    expd = _masked(expd, mask, 0)
    denom = scatter_add(expd, segment_ids, num_segments).clamp_min(finfo.tiny)
    return expd / gather(denom, segment_ids)


def scatter(op: str, data, segment_ids, num_segments, mask=None):
    """Dispatch by name: 'add' | 'sum' | 'mean' | 'max' | 'softmax'."""
    fns = {
        "add": scatter_add,
        "sum": scatter_add,
        "mean": scatter_mean,
        "max": scatter_max,
        "softmax": scatter_softmax,
    }
    return fns[op](data, segment_ids, num_segments, mask=mask)
