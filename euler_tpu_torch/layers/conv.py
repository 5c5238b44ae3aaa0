"""Convolution layers over padded Blocks
(counterpart: euler_tpu/layers/conv.py:23-311): SAGEConv, GCNConv,
GATConv, GraphConv, APPNPConv, SGCNConv, TAGConv and ARMAConv.

A conv consumes (x_dst, x_src, block) and produces new dst embeddings.
flax's Dense infers its input width at init; here each conv is told its
input width (`in_dim`) and tells its stack its output width
(`out_width`: APPNP and SGCN only propagate, so theirs is `in_dim`).
The Linear weight is [out, in] where flax's kernel is [in, out]
(`params.from_flax` transposes). A conv's flax `Dense_<i>` is its
`linear` (i = 0) or `linear_<i>`, in the order flax numbers them: the
order of the calls.

`dtype` is the compute dtype of the layer's linear, as flax's
`Dense(dtype=...)`: the params stay f32, and with dtype=torch.bfloat16
the input and the weight are cast to bf16, multiplied, and the bias is
cast and added in bf16 (flax's rounding points), so the layer outputs
bf16.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from euler_tpu_torch.dataflow.base import Block
from euler_tpu_torch.ops import (
    gather,
    gather_weighted_sum,
    kernel_mode,
    scatter_add,
    scatter_softmax,
)

# flax's lecun_normal: a normal truncated at ±2σ, rescaled so the
# truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """Fill `t` in place as flax's `lecun_normal` initializer draws: a
    normal of σ = sqrt(1/fan_in)/0.8796… truncated at ±2σ, by the inverse
    CDF of a uniform draw (jax.random.truncated_normal's method, and
    torch.nn.init.trunc_normal_'s up to torch 2.11; later versions draw
    by rejection, so the same generator gave other weights)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0  # Φ(-2)
    hi = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0  # Φ(2)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_()
    t.mul_(std * math.sqrt(2.0))
    t.add_(0.0)
    return t.clamp_(min=-2 * std, max=2 * std)


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

    @property
    def out_width(self) -> int:
        """The width of the conv's output rows."""
        return self.out_dim

    def denses(self, *specs) -> None:
        """One Linear a (in, bias) of `specs`, named as flax numbers its
        Dense layers: `linear`, `linear_1`, ..."""
        for i, (width, bias) in enumerate(specs):
            name = "linear" if i == 0 else f"linear_{i}"
            self.add_module(name, nn.Linear(width, self.out_dim, bias=bias))

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


def _sym_norm_propagate(conv: Conv, x_dst, x_src, block: Block, src_scale: float = 1.0):
    """(Σ_src src_scale·x_src + x_dst) · deg_dst^-1/2 with in-batch
    degrees (the mask's, plus the self loop): the propagation GCN's
    in-batch branch, APPNP, SGCN, TAG and ARMA share."""
    norm = torch.pow(degrees(block), -0.5)[:, None]
    msgs = conv.msg(x_src, block)
    if src_scale != 1.0:
        msgs = msgs * src_scale
    return (conv.agg_add(msgs, block) + x_dst) * norm


class GCNConv(Conv):
    """Symmetric-normalized GCN with implicit self loops.

    When the block carries the true graph degrees (src_deg / dst_deg,
    from the full-neighbor and whole-graph flows under gcn_norm=True)
    this is the exact D^-1/2 (A+I) D^-1/2 propagation; otherwise the
    in-batch approximation, where each sampled src slot feeds one dst
    (degree 1, plus 1 for the self loop).
    """

    def __init__(
        self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None, use_bias: bool = True
    ):
        super().__init__(in_dim, out_dim, dtype)
        self.denses((in_dim, use_bias))

    def forward(self, x_dst, x_src, block: Block):
        if block.dst_deg is not None and block.src_deg is not None:
            dd = block.dst_deg + 1.0  # +1: the implicit self loop
            ds = block.src_deg + 1.0
            norm_e = torch.pow(gather(ds, block.edge_src) * gather(dd, block.edge_dst), -0.5)
            msgs = self.msg(x_src, block) * norm_e[:, None]
            h = self.agg_add(msgs, block) + x_dst / dd[:, None]
        else:
            h = _sym_norm_propagate(self, x_dst, x_src, block, 2.0**-0.5)
        return self.dense(self.linear, h)


class GATConv(Conv):
    """Graph attention with a masked softmax over each dst's edges.

    improved=True adds the transformed dst embedding to the output.
    heads > 1 runs multi-head attention; concat=True concatenates the
    heads (out_dim must divide by heads), else they are averaged.

    Grid blocks with one head take the fused path unless the kernel mode
    is 'off': the logits are per-edge scalars, so the softmax is a small
    [n_dst, grid] op (masked slots filled with -1e9, which gives an
    all-masked row zeros, not NaN), and the value gather and weighted sum
    run in `gather_weighted_sum` (kernel 1 and its dx on the card); no
    [E, F] message tensor is made. Other blocks run `scatter_softmax`.
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        dtype: torch.dtype | None = None,
        negative_slope: float = 0.2,
        improved: bool = False,
        heads: int = 1,
        concat: bool = True,
    ):
        super().__init__(in_dim, out_dim, dtype)
        if concat and out_dim % heads:
            raise ValueError(f"out_dim {out_dim} must divide heads {heads}")
        self.negative_slope = negative_slope
        self.improved = improved
        self.heads = heads
        self.concat = concat
        self.per = out_dim // heads if concat else out_dim
        self.linear = nn.Linear(in_dim, self.per * heads, bias=False)
        self.att_src = nn.Parameter(torch.empty(heads, self.per))
        self.att_dst = nn.Parameter(torch.empty(heads, self.per))
        self.reset_like_flax()

    @torch.no_grad()
    def reset_like_flax(self, generator: torch.Generator | None = None) -> None:
        """Draw the attention vectors as flax's lecun_normal does for a
        [heads, per] param (fan_in = heads); `params.init_like_flax`."""
        for p in (self.att_src, self.att_dst):
            lecun_normal_(p, self.heads, generator)

    def forward(self, x_dst, x_src, block: Block):
        heads, per = self.heads, self.per
        total = heads * per
        h_dst = self.dense(self.linear, x_dst)
        h_src = self.dense(self.linear, x_src)
        hd = h_dst.reshape(-1, heads, per)
        hs = h_src.reshape(-1, heads, per)
        a_src = torch.einsum("nhp,hp->nh", hs, self.att_src.to(hs.dtype))
        a_dst = torch.einsum("nhp,hp->nh", hd, self.att_dst.to(hd.dtype))
        e = gather(a_src, block.edge_src) + gather(a_dst, block.edge_dst)
        e = F.leaky_relu(e, self.negative_slope)  # [E, heads]
        mode = kernel_mode()
        if block.grid and mode != "off" and heads == 1:
            d = block.grid
            m2 = block.mask.reshape(-1, d)
            e2 = torch.where(m2, e.reshape(-1, d), -1e9)
            alpha = torch.softmax(e2, dim=1) * m2.to(e2.dtype)
            out = gather_weighted_sum(
                h_src.float(), block.edge_src.reshape(-1, d), alpha.float(), mode
            ).to(h_dst.dtype)
        else:
            alpha = scatter_softmax(e, block.edge_dst, block.n_dst, mask=block.mask)
            msgs = gather(hs, block.edge_src) * alpha[:, :, None]
            out = self.agg_add(msgs.reshape(-1, total), block).reshape(-1, heads, per)
            out = out.reshape(-1, total) if self.concat else out.mean(dim=1)
        if not self.improved:
            return out
        return out + (h_dst if self.concat else hd.mean(dim=1))


class GraphConv(Conv):
    """W1·x_dst + W2·Σ x_src."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None):
        super().__init__(in_dim, out_dim, dtype)
        self.denses((in_dim, True), (in_dim, False))

    def forward(self, x_dst, x_src, block: Block):
        agg = self.agg_add(self.msg(x_src, block), block)
        return self.dense(self.linear, x_dst) + self.dense(self.linear_1, agg)


class APPNPConv(Conv):
    """One APPNP propagation step, (1-α)·Â h + α·h0, with no weights:
    the output keeps the input's width."""

    def __init__(
        self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None, alpha: float = 0.1
    ):
        super().__init__(in_dim, out_dim, dtype)
        self.alpha = alpha

    @property
    def out_width(self) -> int:
        return self.in_dim

    def forward(self, x_dst, x_src, block: Block, x0_dst=None):
        agg = _sym_norm_propagate(self, x_dst, x_src, block, 2.0**-0.5)
        x0 = x_dst if x0_dst is None else x0_dst
        return (1.0 - self.alpha) * agg + self.alpha * x0


class SGCNConv(Conv):
    """Simplified GCN: propagation only, no weights; the output keeps the
    input's width."""

    @property
    def out_width(self) -> int:
        return self.in_dim

    def forward(self, x_dst, x_src, block: Block):
        return _sym_norm_propagate(self, x_dst, x_src, block, 2.0**-0.5)


class TAGConv(Conv):
    """Topology-adaptive GCN: W·[h0 ‖ Â h0] per hop step."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None):
        super().__init__(in_dim, out_dim, dtype)
        self.denses((2 * in_dim, True))

    def forward(self, x_dst, x_src, block: Block):
        prop = _sym_norm_propagate(self, x_dst, x_src, block)
        return self.dense(self.linear, torch.cat([x_dst, prop], dim=-1))


class ARMAConv(Conv):
    """ARMA_K filter, one GCS step a stack: relu(Â·x·W + x0·V), the
    stacks averaged. Stack s owns Dense 2s (W, no bias) and 2s + 1 (V)."""

    def __init__(
        self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None, stacks: int = 2
    ):
        super().__init__(in_dim, out_dim, dtype)
        self.stacks = stacks
        self.denses(*[(in_dim, bias) for _ in range(stacks) for bias in (False, True)])

    def forward(self, x_dst, x_src, block: Block):
        prop = _sym_norm_propagate(self, x_dst, x_src, block)
        outs = []
        for s in range(self.stacks):
            w = self.linear if s == 0 else getattr(self, f"linear_{2 * s}")
            v = getattr(self, f"linear_{2 * s + 1}")
            outs.append(F.relu(self.dense(w, prop) + self.dense(v, x_dst)))
        return sum(outs) / self.stacks
