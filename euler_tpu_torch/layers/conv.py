"""Convolution layers over padded Blocks
(counterpart: euler_tpu/layers/conv.py:23-119).

A conv consumes (x_dst, x_src, block) and produces new dst embeddings.
flax's Dense infers its input width at init; here each conv is told its
input width (`in_dim`), and the Linear weight is [out, in] where flax's
kernel is [in, out] (`params.from_flax` transposes).

`dtype` is the compute dtype of the layer's linear, as flax's
`Dense(dtype=...)`: the params stay f32, and with dtype=torch.bfloat16
the input and the weight are cast to bf16, multiplied, and the bias is
cast and added in bf16 (flax's rounding points), so the layer outputs
bf16.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from euler_tpu_torch.dataflow.base import Block
from euler_tpu_torch.ops import gather, gather_weighted_sum, kernel_mode, scatter_add


def degrees(block: Block, with_self: bool = True) -> torch.Tensor:
    """deg_dst computed from the block mask (+1 for the self loop)."""
    ones = block.mask.float()
    deg_dst = scatter_add(ones, block.edge_dst, block.n_dst)
    if with_self:
        deg_dst = deg_dst + 1.0
    return deg_dst


class Conv(nn.Module):
    """Base conv: subclasses implement forward(x_dst, x_src, block)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.dtype = dtype

    def dense(self, linear: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        """`linear(h)` in the compute dtype (module docstring)."""
        if self.dtype is None:
            return linear(h)
        y = F.linear(h.to(self.dtype), linear.weight.to(self.dtype))
        return y if linear.bias is None else y + linear.bias.to(self.dtype)

    def msg(self, x_src, block: Block):
        return gather(x_src, block.edge_src)

    def agg_add(self, msgs, block: Block):
        return scatter_add(msgs, block.edge_dst, block.n_dst, mask=block.mask)


class SAGEConv(Conv):
    """GraphSAGE mean aggregator: W·[x_dst ‖ mean(x_src)].

    Grid-structured blocks take the fused gather_weighted_sum path (mean =
    gather_weighted_sum with w = mask/deg) unless the kernel mode is
    'off'; that path never writes the [E, F] message tensor.
    """

    def __init__(
        self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None, use_bias: bool = True
    ):
        super().__init__(in_dim, out_dim, dtype)
        self.linear = nn.Linear(2 * in_dim, out_dim, bias=use_bias)

    def forward(self, x_dst, x_src, block: Block):
        mode = kernel_mode()
        if block.grid and mode != "off":
            d = block.grid
            m = block.mask.reshape(-1, d).float()
            w = m / m.sum(dim=1, keepdim=True).clamp_min(1.0)
            slots = block.edge_src.reshape(-1, d)
            mean = gather_weighted_sum(x_src, slots, w, mode).to(x_dst.dtype)
        else:
            msgs = self.msg(x_src, block)
            total = self.agg_add(msgs, block)
            count = scatter_add(
                torch.ones(block.edge_src.shape[0], device=x_src.device),
                block.edge_dst,
                block.n_dst,
                mask=block.mask,
            )
            mean = total / count.clamp_min(1.0)[:, None]
        return self.dense(self.linear, torch.cat([x_dst, mean], dim=-1))
