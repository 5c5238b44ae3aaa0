"""Graph-level readouts (counterpart: euler_tpu/nn/pooling.py): segment
pooling (add / mean / max under the node mask), attention pooling (a
gate Dense, `scatter_softmax` within each graph, an optional projection)
and Set2Set (an LSTM attention readout). Each pool is built from the
width of the node rows it reads and tells its width in `out_width`.
"""

from __future__ import annotations

import torch
from torch import nn

from euler_tpu_torch.nn.cells import LSTMCell
from euler_tpu_torch.ops import gather, scatter, scatter_softmax


class Pooling(nn.Module):
    """Plain segment pooling over graph ids; op ∈ {add, mean, max}."""

    def __init__(self, in_dim: int, op: str = "mean"):
        super().__init__()
        self.op = op
        self.out_width = in_dim

    def forward(self, x, graph_ids, n_graphs: int, mask=None):
        return scatter(self.op, x, graph_ids, n_graphs, mask=mask)


class AttentionPool(nn.Module):
    """Gated attention readout: α = softmax over each graph of the gate
    Dense (`linear`, flax's Dense_0), then Σ α·proj(x), proj the Dense
    `linear_1` to `dim` when dim > 0, else the identity."""

    def __init__(self, in_dim: int, dim: int = 0):
        super().__init__()
        self.dim = dim
        self.linear = nn.Linear(in_dim, 1)
        if dim:
            self.linear_1 = nn.Linear(in_dim, dim)
        self.out_width = dim or in_dim

    def forward(self, x, graph_ids, n_graphs: int, mask=None):
        alpha = scatter_softmax(self.linear(x)[:, 0], graph_ids, n_graphs, mask=mask)
        h = self.linear_1(x) if self.dim else x
        return scatter("add", h * alpha[:, None], graph_ids, n_graphs, mask=mask)


class Set2SetPool(nn.Module):
    """Set2Set readout: `steps` rounds of q = LSTM(q*) from a zero carry
    and q* = 0, α = softmax over each graph of x·q, read = Σ α·x, q* =
    [q ‖ read]; the output is the last q* (2 × the input width)."""

    def __init__(self, in_dim: int, steps: int = 3):
        super().__init__()
        self.steps = steps
        self.lstm = LSTMCell(2 * in_dim, in_dim)
        self.out_width = 2 * in_dim

    def forward(self, x, graph_ids, n_graphs: int, mask=None):
        d = x.shape[-1]
        zeros = torch.zeros((n_graphs, d), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros)
        q_star = x.new_zeros((n_graphs, 2 * d))
        for _ in range(self.steps):
            carry, q = self.lstm(carry, q_star)
            e = torch.sum(x * gather(q, graph_ids), dim=-1)
            alpha = scatter_softmax(e, graph_ids, n_graphs, mask=mask)
            read = scatter("add", x * alpha[:, None], graph_ids, n_graphs, mask=mask)
            q_star = torch.cat([q, read], dim=-1)
        return q_star


# pool name -> constructor from the node rows' width
POOLS = {
    "add": lambda in_dim: Pooling(in_dim, "add"),
    "mean": lambda in_dim: Pooling(in_dim, "mean"),
    "max": lambda in_dim: Pooling(in_dim, "max"),
    "attention": AttentionPool,
    "set2set": Set2SetPool,
}
