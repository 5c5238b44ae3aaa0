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

from euler_tpu_torch.dataflow.base import MiniBatch
from euler_tpu_torch.layers import get_conv


class GNNNet(nn.Module):
    """Stack of shared-per-layer convs over a fanout MiniBatch.

    in_dim: width of the input node features
    conv: layer name from euler_tpu_torch.layers.CONVS
    dims: output width per layer; len(dims) must equal len(batch.blocks)
    conv_kwargs: passed to every conv (e.g. {"dtype": torch.bfloat16})
    remat (rematerialised layers) is not ported yet.
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
        if remat:
            raise NotImplementedError("GNNNet(remat=True) is not ported yet")
        cls = get_conv(conv)
        widths = [in_dim] + list(dims)
        kwargs = dict(conv_kwargs or {})
        self.convs = nn.ModuleList(
            cls(widths[i], widths[i + 1], **kwargs) for i in range(len(dims))
        )
        self.dims = list(dims)
        self.activation = activation

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
                h = conv(xs[hop], xs[hop + 1], batch.blocks[hop])
                if not last:
                    h = act(h)
                # zero out padded node slots so garbage never propagates
                h = h * batch.masks[hop][: h.shape[0], None].to(h.dtype)
                new_xs.append(h)
            xs = new_xs
        return xs[0]
