"""Attribute indexes and the DNF condition algebra, as far as the
retrieval corpus's filters need them (counterpart: euler_tpu/graph/index.py:
`IndexResult`, `HashIndex`, `RangeIndex`, `_key`, `_union_many`,
`DnfEvaluator` and the `OPS` vocabulary; the graph shard's `IndexManager`
and `HashRangeIndex` are not ported yet).

`HashIndex` answers eq/in over discrete attribute values, `RangeIndex`
answers lt/le/gt/ge/eq over ordered scalars; search results are
`IndexResult` row sets whose intersection and union compose a DNF
condition. Everything is vectorized numpy over columnar arrays.

A condition is DNF: a list of AND-clauses, each clause a list of atoms
`(field, op, value)`; the whole condition is the OR of its clauses.
Ops: eq ne lt le gt ge in not_in haskey.
"""

from __future__ import annotations

import numpy as np

OPS = ("eq", "ne", "lt", "le", "gt", "ge", "in", "not_in", "haskey")


class IndexResult:
    """A set of local row indices with the owner's sampling weights.
    Rows are kept sorted and unique so intersection/union are linear
    merges."""

    def __init__(self, rows: np.ndarray, weights: np.ndarray):
        self.rows = np.asarray(rows, dtype=np.int64)
        self._weights = weights  # full per-row weight column (shared)

    def intersect(self, other: "IndexResult") -> "IndexResult":
        return IndexResult(
            np.intersect1d(self.rows, other.rows, assume_unique=True),
            self._weights,
        )

    def union(self, other: "IndexResult") -> "IndexResult":
        return IndexResult(np.union1d(self.rows, other.rows), self._weights)

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def total_weight(self) -> float:
        return float(self._weights[self.rows].sum()) if len(self.rows) else 0.0

    def sample(self, count: int, rng: np.random.Generator) -> np.ndarray:
        """Weighted sample (with replacement) of `count` rows; -1 if empty."""
        if len(self.rows) == 0:
            return np.full(count, -1, dtype=np.int64)
        w = np.asarray(self._weights[self.rows], dtype=np.float64)
        cum = np.cumsum(w)
        if cum[-1] <= 0:
            return np.full(count, -1, dtype=np.int64)
        u = rng.random(count) * cum[-1]
        return self.rows[np.searchsorted(cum, u, side="right")]

    def contains(self, rows: np.ndarray) -> np.ndarray:
        """Membership mask for arbitrary row indices (vectorized)."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(self.rows) == 0:
            return np.zeros(rows.shape, dtype=bool)
        pos = np.searchsorted(self.rows, rows)
        pos = np.clip(pos, 0, len(self.rows) - 1)
        return (self.rows[pos] == rows) & (rows >= 0)


class HashIndex:
    """value → rows, for discrete (u64 / bytes / int) attributes. Rows may
    appear under several values (multi-valued attributes)."""

    def __init__(self, table: dict, num_rows: int, nonempty: np.ndarray):
        self._table = table  # value → sorted row array
        self._num_rows = num_rows
        self._nonempty = nonempty  # sorted rows that carry the attribute

    @classmethod
    def build(cls, rows: np.ndarray, values: np.ndarray, num_rows: int):
        order = np.argsort(values, kind="stable")
        rows, values = rows[order], values[order]
        table = {}
        if len(values):
            cuts = np.flatnonzero(np.r_[True, values[1:] != values[:-1]])
            bounds = np.r_[cuts, len(values)]
            for i, c in enumerate(cuts):
                v = values[c]
                table[v.item() if isinstance(v, np.generic) else v] = np.sort(
                    rows[c : bounds[i + 1]]
                )
        return cls(table, num_rows, np.unique(rows))

    def _all(self) -> np.ndarray:
        return np.arange(self._num_rows, dtype=np.int64)

    def search(self, op: str, value) -> np.ndarray:
        if op == "haskey":
            return self._nonempty
        if op == "eq":
            return self._table.get(_key(value), np.empty(0, np.int64))
        if op == "in":
            return _union_many(
                [self._table.get(_key(v), np.empty(0, np.int64)) for v in value]
            )
        if op == "ne":
            return np.setdiff1d(self._all(), self.search("eq", value))
        if op == "not_in":
            return np.setdiff1d(self._all(), self.search("in", value))
        raise ValueError(f"hash index does not support op {op!r}")


class RangeIndex:
    """Ordered scalar attribute → row ranges via binary search over the
    sorted (value, row) pairs; lt/le/gt/ge/eq become contiguous slices of
    the sort order."""

    def __init__(self, sorted_vals: np.ndarray, order_rows: np.ndarray):
        self._vals = sorted_vals
        self._rows = order_rows

    @classmethod
    def build(cls, values: np.ndarray):
        values = np.asarray(values)
        # integers (incl. uint64 ids) stay exact; everything else compares
        # as float64
        if not np.issubdtype(values.dtype, np.integer):
            values = values.astype(np.float64)
        order = np.argsort(values, kind="stable")
        return cls(values[order], order.astype(np.int64))

    def _coerce(self, value):
        """Search value → the index dtype; None = below an unsigned domain."""
        if not isinstance(value, (int, float, str, np.integer, np.floating)):
            # a list here means a malformed condition (an `in` list given
            # to a scalar comparator): a query error, not a TypeError
            raise ValueError(
                f"scalar comparison value expected, got {type(value).__name__}"
            )
        dt = self._vals.dtype
        integral = isinstance(value, (int, np.integer)) or (
            isinstance(value, float) and value.is_integer()
        )
        if np.issubdtype(dt, np.integer):
            if not integral:
                # fractional threshold over an integer column compares as
                # float64 (exactness above 2**53 is not preserved)
                return float(value)
            if int(value) < 0 and np.issubdtype(dt, np.unsignedinteger):
                return None
            return dt.type(int(value))
        return float(value)

    def search(self, op: str, value) -> np.ndarray:
        n = len(self._vals)
        if op == "in":
            return _union_many([self.search("eq", x) for x in value])
        if op == "not_in":
            return np.setdiff1d(np.sort(self._rows), self.search("in", value))
        if op == "haskey":
            return np.sort(self._rows)
        v = self._coerce(value)
        if v is None:  # negative value vs unsigned column
            if op in ("lt", "le", "eq"):
                return np.empty(0, np.int64)
            return np.sort(self._rows)  # gt/ge/ne match everything
        if op == "lt":
            sl = slice(0, np.searchsorted(self._vals, v, "left"))
        elif op == "le":
            sl = slice(0, np.searchsorted(self._vals, v, "right"))
        elif op == "gt":
            sl = slice(np.searchsorted(self._vals, v, "right"), n)
        elif op == "ge":
            sl = slice(np.searchsorted(self._vals, v, "left"), n)
        elif op == "eq":
            sl = slice(
                np.searchsorted(self._vals, v, "left"),
                np.searchsorted(self._vals, v, "right"),
            )
        elif op == "ne":
            return np.sort(
                np.r_[
                    self._rows[: np.searchsorted(self._vals, v, "left")],
                    self._rows[np.searchsorted(self._vals, v, "right") :],
                ]
            )
        else:
            raise ValueError(f"range index does not support op {op!r}")
        return np.sort(self._rows[sl])


def _key(v):
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return int(v) if isinstance(v, (int, np.integer)) else v


def _union_many(parts: list[np.ndarray]) -> np.ndarray:
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(parts))


class DnfEvaluator:
    """DNF walk over per-field indexes. Subclasses provide
    `_index_for(field)` plus `_weights`/`_num_rows`; AND intersects within
    a clause, OR unions across clauses, and an empty DNF is everything."""

    _weights: np.ndarray
    _num_rows: int

    def _index_for(self, field: str):  # pragma: no cover - abstract
        raise NotImplementedError

    def search(self, field: str, op: str, value=None) -> IndexResult:
        if op not in OPS:
            raise ValueError(f"unknown condition op {op!r}")
        return IndexResult(self._index_for(field).search(op, value), self._weights)

    def search_dnf(self, dnf) -> IndexResult:
        """dnf = [[(field, op, value), ...AND...], ...OR...]."""
        out: IndexResult | None = None
        for clause in dnf:
            cur: IndexResult | None = None
            for atom in clause:
                field, op, value = (tuple(atom) + (None,))[:3]
                res = self.search(field, op, value)
                cur = res if cur is None else cur.intersect(res)
            if cur is None:
                continue
            out = cur if out is None else out.union(cur)
        if out is None:
            out = IndexResult(np.arange(self._num_rows, dtype=np.int64), self._weights)
        return out
