"""Feature encoders (counterpart: euler_tpu/nn/encoders.py:22-45).

`Embedding` is the id-embedding table of the shallow-embedding and
knowledge-graph models. `SparseEmbedding` and `ShallowEncoder` are not
ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from euler_tpu_torch.ops import gather


def normal_rows(stddev: float = 0.02) -> Callable:
    """flax's `initializers.normal(stddev)` as a row init."""

    def init(shape, generator=None):
        return torch.randn(shape, generator=generator) * stddev

    return init


def zeros_rows(shape, generator=None):
    """flax's `initializers.zeros` as a row init."""
    return torch.zeros(shape)


class Embedding(nn.Module):
    """Id-embedding table of `ceil(vocab / 128) * 128` rows (the JAX
    package's lane-aligned padding). Ids are clipped to [0, vocab - 1],
    so an out-of-range id, such as the padding id -1, reads a real row
    and never raises, as in JAX.

    row_init(shape, generator) → f32 tensor overrides the default
    normal(0.02) init: the KG models start relation projections at
    identity or zero. `partitioned` (the table sharded over a mesh's
    model axis) is accepted for the signature and has no effect without
    a mesh, which the port does not have yet.
    """

    def __init__(self, vocab: int, dim: int, partitioned: bool = True, row_init=None):
        super().__init__()
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.partitioned = partitioned
        self.row_init = row_init or normal_rows(0.02)
        rows = -(-self.vocab // 128) * 128
        self.table = nn.Parameter(self.row_init((rows, self.dim)).float())

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw the table again from `row_init` (`params.init_like_flax`)."""
        self.table.copy_(self.row_init(tuple(self.table.shape), generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return gather(self.table, ids.clamp(0, self.vocab - 1))
