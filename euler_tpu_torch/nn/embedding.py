"""Partial updates of (partitioned) embedding tables
(counterpart: euler_tpu/nn/embedding.py).

Functional, as the JAX package's `.at[rows]` forms: each call returns a
new table and leaves its input as it was. `embedding_add` sums every
duplicate id (`index_put_(accumulate=True)`, the sorted sum on CUDA, as
`ops.mp_ops` sums); for `embedding_update` on repeated ids the JAX
package promises no order, and neither does the port. The mod-partitioned
list-of-tables form keeps row `id // P` of table `id % P`.
"""

from __future__ import annotations

import torch


def _index(ids) -> torch.Tensor:
    return torch.as_tensor(ids).long()


def embedding_update(table, ids, values):
    """rows[ids] = values (tf.scatter_update parity)."""
    out = table.clone()
    out[_index(ids)] = values.to(out.dtype)
    return out


def embedding_add(table, ids, values):
    """rows[ids] += values (tf.scatter_add parity); duplicates all add."""
    return table.clone().index_put_((_index(ids),), values.to(table.dtype), accumulate=True)


def embedding_moving_average(table, ids, values, momentum: float):
    """rows[ids] = m*rows[ids] + (1-m)*values (history-embedding refresh)."""
    ids = _index(ids)
    return embedding_update(table, ids, momentum * table[ids] + (1.0 - momentum) * values)


def _mod_partition(ids, num_parts: int):
    """mod strategy: part = id % P, local row = id // P."""
    ids = _index(ids)
    return torch.remainder(ids, num_parts), torch.div(ids, num_parts, rounding_mode="floor")


def partitioned_lookup(tables: list, ids):
    """Rows of mod-partitioned tables (embedding_lookup parity): each
    table p holds the ids with id % P == p at local row id // P; every
    partition is read with a masked select, as the JAX package's fixed
    shapes do."""
    part, local = _mod_partition(ids, len(tables))
    out = torch.zeros(tuple(part.shape) + tuple(tables[0].shape[1:]), dtype=tables[0].dtype,
                      device=tables[0].device)
    for p, t in enumerate(tables):
        sel = part == p
        rows = torch.where(sel, local, torch.zeros_like(local))
        out = torch.where(sel[..., None], t[rows], out)
    return out


def partitioned_update(tables: list, ids, values, func=embedding_update, momentum: float = 0.9):
    """Scatter `values` into mod-partitioned tables; returns new tables.

    func is embedding_update, embedding_add or embedding_moving_average
    (`momentum` applies to the moving-average form only); any other func
    raises, as a silent fall-through to overwrite would corrupt the
    table. Duplicate ids within one call have undefined precedence, as
    in the JAX package."""
    if func not in (embedding_update, embedding_add, embedding_moving_average):
        raise ValueError(
            "partitioned_update supports embedding_update / embedding_add /"
            f" embedding_moving_average, got {func!r}"
        )
    part, local = _mod_partition(ids, len(tables))
    out = []
    for p, t in enumerate(tables):
        sel = (part == p)[..., None]
        rows = torch.where(part == p, local, torch.zeros_like(local))
        if func is embedding_add:
            delta = torch.where(sel, values, torch.zeros_like(values))
        elif func is embedding_moving_average:
            # new = m*old + (1-m)*v  ->  delta = (1-m)*(v - old)
            delta = torch.where(sel, (1.0 - momentum) * (values - t[rows]),
                                torch.zeros_like(values))
        else:
            # set as an add of (value - current): unselected ids collapse to
            # row 0 with delta 0, so collisions there are harmless
            delta = torch.where(sel, values - t[rows], torch.zeros_like(values))
        out.append(embedding_add(t, rows, delta))
    return out
