"""Feature encoders (counterpart: euler_tpu/nn/encoders.py:22-99).

`Embedding` is the id-embedding table of the shallow-embedding and
knowledge-graph models; `SparseEmbedding` a masked bag of ids over one;
`ShallowEncoder` the input stage of the id-embedding GraphSAGE: an id
embedding, a projection of the dense features and sparse embeddings,
added or concatenated. The submodules keep flax's compact names
(`Embedding_0`, `Dense_0` as `linear`, `SparseEmbedding_<j>`), so
`params.from_flax` maps them path by path.
"""

from __future__ import annotations

from typing import Callable, Sequence

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


class SparseEmbedding(nn.Module):
    """Masked bag-of-ids embedding: ids [..., L] hashed into the table by
    floor modulo (`torch.remainder`, as jnp's `%`: a negative id takes a
    row in [0, vocab)), mask bool[..., L]; combiner "mean" (the sum over
    max(count, 1)) or "sum"."""

    def __init__(self, vocab: int, dim: int, combiner: str = "mean"):
        super().__init__()
        self.vocab = int(vocab)
        self.combiner = combiner
        self.Embedding_0 = Embedding(vocab, dim, partitioned=True)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = self.Embedding_0(torch.remainder(ids, self.vocab))
        m = mask.to(emb.dtype)[..., None]
        total = torch.sum(emb * m, dim=-2)
        if self.combiner == "sum":
            return total
        return total / torch.sum(m, dim=-2).clamp_min(1.0)


class ShallowEncoder(nn.Module):
    """id embedding ⊕ dense projection ⊕ sparse embeddings, in that order,
    combined by "add" or "concat". The id embedding (vocab max_id + 1)
    runs when max_id > 0 and ids are given; the dense part when dense
    features of width > 0 are given: `Linear(in_dim, dim)` of them, or
    the features themselves when use_feature_proj=False. `in_dim` is the
    dense features' width, which flax infers at init (0: no projection).
    With no part it raises ValueError, as the JAX package does."""

    def __init__(self, in_dim: int, dim: int, max_id: int = 0, sparse_vocabs: Sequence[int] = (),
                 combiner: str = "add", use_feature_proj: bool = True):
        super().__init__()
        self.dim = int(dim)
        self.max_id = int(max_id)
        self.sparse_vocabs = tuple(int(v) for v in sparse_vocabs)
        self.combiner = combiner
        self.use_feature_proj = use_feature_proj
        if self.max_id > 0:
            self.Embedding_0 = Embedding(self.max_id + 1, self.dim)
        if use_feature_proj and in_dim > 0:
            self.linear = nn.Linear(int(in_dim), self.dim)
        for j, vocab in enumerate(self.sparse_vocabs):
            self.add_module(f"SparseEmbedding_{j}", SparseEmbedding(vocab, self.dim))

    def forward(self, ids=None, dense=None, sparse=None) -> torch.Tensor:
        """ids: int[...]; dense: f32[..., F]; sparse: [(ids, mask), ...]."""
        parts = []
        if self.max_id > 0 and ids is not None:
            parts.append(self.Embedding_0(ids))
        if dense is not None and dense.shape[-1] > 0:
            if not self.use_feature_proj:
                parts.append(dense)
            elif not hasattr(self, "linear"):
                raise ValueError(f"ShallowEncoder got {dense.shape[-1]}-wide dense features "
                                 "and was built with in_dim=0")
            else:
                parts.append(self.linear(dense))
        for j, (_, (sids, smask)) in enumerate(zip(self.sparse_vocabs, sparse or ())):
            parts.append(getattr(self, f"SparseEmbedding_{j}")(sids, smask))
        if not parts:
            raise ValueError("ShallowEncoder needs at least one input kind")
        if self.combiner == "concat":
            return torch.cat(parts, dim=-1)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
