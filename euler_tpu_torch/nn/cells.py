"""Recurrent cells (counterpart: flax.linen's `GRUCell` and `LSTMCell`,
flax 0.12.3, which the JAX package's GatedGraphConv, GeniePathConv and
Set2SetPool use).

flax's submodule names and bias placement are kept, so the param trees
map one to one (`params.from_flax`): a gate's input Linear is named
`i<gate>`, its hidden Linear `h<gate>`.

- GRU: `ir iz in` with a bias, `hr hz` without, `hn` with;
  r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)), n = tanh(in(x) + r·hn(h)),
  h' = (1 - z)·n + z·h.
- LSTM: `ii if ig io` without a bias, `hi hf hg ho` with;
  c' = f·c + i·g, h' = o·tanh(c').

`dtype` is the compute dtype of the Linears, as `layers.conv.dense`
applies it (flax's `Dense(dtype=...)`). The hidden Linears' kernels take
flax's orthogonal init (`params.flax_init`), the input ones lecun_normal.
"""

from __future__ import annotations

import torch
from torch import nn

from euler_tpu_torch.layers.conv import dense, lecun_normal_

GRU_GATES = ("r", "z", "n")
LSTM_GATES = ("i", "f", "g", "o")


class _Cell(nn.Module):
    # `params.init_like_flax` leaves the cell's Linears to its reset_like_flax
    resets_subtree = True

    def __init__(self, in_dim: int, features: int, gates, input_bias, hidden_bias,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.features = features
        self.gates = gates
        self.dtype = dtype
        for g in gates:
            self.add_module(f"i{g}", nn.Linear(in_dim, features, bias=input_bias(g)))
            self.add_module(f"h{g}", nn.Linear(features, features, bias=hidden_bias(g)))

    @torch.no_grad()
    def reset_like_flax(self, generator: torch.Generator | None = None) -> None:
        """Draw as flax's cell initialises: the input kernels lecun_normal,
        the hidden ones orthogonal (a normal draw, its QR, Q's columns
        signed by R's diagonal), every bias 0; gate by gate, input first."""
        for g in self.gates:
            li, lh = getattr(self, f"i{g}"), getattr(self, f"h{g}")
            lecun_normal_(li.weight, li.in_features, generator)
            z = torch.randn(self.features, self.features, generator=generator)
            q, r = torch.linalg.qr(z)
            lh.weight.copy_((q * torch.sign(torch.diagonal(r))).T)
            for lin in (li, lh):
                if lin.bias is not None:
                    lin.bias.zero_()

    def _gate(self, g: str, x, h):
        return dense(getattr(self, f"i{g}"), x, self.dtype), dense(getattr(self, f"h{g}"), h,
                                                                     self.dtype)


class GRUCell(_Cell):
    """`flax.linen.GRUCell`: forward(h, x) -> h'."""

    def __init__(self, in_dim: int, features: int, dtype: torch.dtype | None = None):
        super().__init__(in_dim, features, GRU_GATES, lambda g: True, lambda g: g == "n", dtype)

    def forward(self, h, x):
        r = torch.sigmoid(sum(self._gate("r", x, h)))
        z = torch.sigmoid(sum(self._gate("z", x, h)))
        xn, hn = self._gate("n", x, h)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class LSTMCell(_Cell):
    """`flax.linen.LSTMCell`: forward((c, h), x) -> ((c', h'), h')."""

    def __init__(self, in_dim: int, features: int, dtype: torch.dtype | None = None):
        super().__init__(in_dim, features, LSTM_GATES, lambda g: False, lambda g: True, dtype)

    def forward(self, carry, x):
        c, h = carry
        i, f, g, o = (sum(self._gate(k, x, h)) for k in LSTM_GATES)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (c, h), h
