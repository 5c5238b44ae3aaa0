"""GNN networks over MiniBatch blocks
(counterpart: euler_tpu/nn/base_gnn.py:21-66).

Layer l transforms hops [0, H-l) with one shared conv per layer,
consuming one block per step, so after H layers hop 0 carries the root
embeddings.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.layers import get_conv


def call_layer(layer: nn.Module, remat: bool, *args) -> torch.Tensor:
    """`layer(*args)`; with `remat`, its activations are dropped after the
    forward and recomputed in the backward pass (flax's `nn.remat`): a
    fanout batch's activations, Σ_l B·Πk_i·F a layer, for one more
    forward. The recompute relaunches the layer's kernels (kernel 1's
    forward beside its dx kernel). It keeps no RNG state: no conv draws
    (the flows' draws are inputs), and reading the CUDA generator's state
    is illegal while a step is captured (steps_per_call > 1)."""
    if not (remat and torch.is_grad_enabled()):
        return layer(*args)
    return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)


class GNNNet(nn.Module):
    """Stack of shared-per-layer convs over a fanout MiniBatch.

    in_dim: width of the input node features
    conv: layer name from euler_tpu_torch.layers.CONVS
    dims: output width per layer; len(dims) must equal len(batch.blocks)
    conv_kwargs: passed to every conv (e.g. {"dtype": torch.bfloat16})
    remat: recompute each conv call's activations in the backward pass
      (`call_layer`); the same numbers, less memory.

    Each conv gets the width its predecessor outputs (flax infers it):
    a weightless conv (APPNP, SGCN) passes its input width on, not its
    `dims` entry. `out_dim` is the width of the embeddings.
    """

    def __init__(
        self,
        in_dim: int,
        conv: str,
        dims: Sequence[int],
        activation: str = "relu",
        conv_kwargs: dict | None = None,
        remat: bool = False,
    ):
        super().__init__()
        cls = get_conv(conv)
        kwargs = dict(conv_kwargs or {})
        convs, width = [], in_dim
        for d in dims:
            convs.append(cls(width, d, **kwargs))
            width = convs[-1].out_width
        self.convs = nn.ModuleList(convs)
        self.out_dim = width
        self.dims = list(dims)
        self.activation = activation
        self.remat = remat

    def forward(self, batch: MiniBatch) -> torch.Tensor:
        num_hops = len(batch.blocks)
        if len(self.dims) != num_hops:
            raise ValueError(f"dims {self.dims} must match hop count {num_hops}")
        act = getattr(F, self.activation)
        xs = list(batch.feats)
        for layer in range(num_hops):
            conv = self.convs[layer]
            last = layer == num_hops - 1
            new_xs = []
            for hop in range(num_hops - layer):
                h = call_layer(conv, self.remat, xs[hop], xs[hop + 1], batch.blocks[hop])
                if not last:
                    h = act(h)
                # zero out padded node slots so garbage never propagates
                h = h * batch.masks[hop][: h.shape[0], None].to(h.dtype)
                new_xs.append(h)
            xs = new_xs
        return xs[0]
