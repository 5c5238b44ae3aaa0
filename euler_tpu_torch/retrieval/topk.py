"""Brute-force top-K over an embedding corpus — the compute half of
retrieval (counterpart: euler_tpu/retrieval/topk.py).

`TopKIndex` stages one (immutable) corpus's lane-row table on the device
once and answers masked dot/cosine top-K: the queries are padded up to a
bucket and scored by `paged_topk_score`, and the top k are picked in
canonical order. On the card a search is two kernel launches, the scorer
and `paged_topk_select` (each tile's top k as int64 keys, the mask read
in the kernel), and one `torch.topk` over the candidates (`topk_keys`).
The scorer runs its FMA template when `products_exact` holds for the
search's queries and the corpus (the corpus's |x| range is taken once at
staging; the queries' on each search), as it does for the unit vectors
of a cosine corpus; operands whose products could leave f32's normal
range get the mul/add template. Both give the same bits. On CPU tensors and
under impl 'ref' the plain versions run: the scorer's loop, the mask as
`torch.where` and `canonical_topk` over the whole [B, N] scores.

Bit-determinism contract, the JAX package's:

  * scoring operands are significand-truncated to 12 bits (corpus.py
    `quantize_sig12`: corpus rows at build time, queries here), so every
    q*x product is exact in f32;
  * scores accumulate strictly left to right in f32 (the scorer's
    contract), so they are bit-identical across impls and against NumPy;
  * ties break (score desc, id asc): corpus rows are sorted by id
    ascending and the selection prefers the lower index on equal scores,
    as `lax.top_k` does, at the k-th place too (`canonical_topk`);
  * filtered retrieval masks scores to -inf before selection, so a filter
    only removes candidates, never perturbs surviving scores.

`numpy_topk_oracle` is the independent pure-NumPy implementation of the
same spec, copied as it is from the JAX package; `merge_topk` is the
canonical-order heap merge that fuses per-shard answers.
"""

from __future__ import annotations

import heapq
import threading

import numpy as np
import torch

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.ops.paged import _resolve
from euler_tpu_torch.ops.topk_score import (
    operand_range,
    order_keys,
    paged_topk_score,
    paged_topk_select,
    products_exact,
    topk_keys,
)
from euler_tpu_torch.retrieval.corpus import (
    INVALID_ID,
    EmbeddingCorpus,
    normalize_rows,
    quantize_sig12,
)

# query-batch buckets: requests pad up to the smallest fitting bucket;
# beyond the largest, to its next multiple
BUCKETS = (1, 4, 16, 64)


def bucket_for(b: int, buckets=BUCKETS) -> int:
    for cand in buckets:
        if b <= cand:
            return cand
    top = buckets[-1]
    return -(-b // top) * top


def canonical_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) [B, k] of the k largest f32 scores per row, in
    (score desc, index asc) order: `lax.top_k`'s answer, ties at the k-th
    place included. `torch.topk` alone promises no order among equal
    values, so each score is made unique first: an int64 key whose high
    half orders as the float does and whose low half is the complement of
    the index (`order_keys`). The values come back from the keys bit for
    bit. Needs fewer than 2^32 columns."""
    return topk_keys(order_keys(scores), k)


class TopKIndex:
    """Bucket-padded top-K over one EmbeddingCorpus staged on `device`
    (default: the CUDA card; pass device="cpu" to run on the CPU)."""

    def __init__(self, corpus: EmbeddingCorpus, impl: str = "auto",
                 buckets=BUCKETS, device=None):
        self.corpus = corpus
        self.impl = impl
        self.buckets = tuple(buckets)
        self.device = resolve_device(device)
        self._n = corpus.num_rows
        self._dp = corpus.dim_padded
        # the paged table: staged once per corpus version (the hot-swap
        # unit is the whole TopKIndex)
        self.table2d = (
            torch.from_numpy(corpus.lane_rows()).to(self.device) if self._n else None
        )
        # (min nonzero |x|, max |x|) for the FMA template's guard
        self._x_range = operand_range(corpus.vectors) if self._n else None
        # kernel-path searches by the scorer template they ran
        self.templates = {"fma": 0, "mul_add": 0}
        # the (bucket, k) shapes searched so far: the JAX package compiles
        # one program for each, this port runs eagerly
        self._programs: set[tuple[int, int]] = set()
        # a server's pool workers search one index at once: the two
        # bookkeeping updates above are read-modify-writes
        self._book_lock = threading.Lock()

    def warmup(self, k: int, buckets=None) -> int:
        """Run each bucket once at k off the serving path (builds the
        kernel library, warms the allocator). Returns the (bucket, k)
        shapes not searched before."""
        before = len(self._programs)
        if self._n:
            keff = min(int(k), self._n)
            probe = np.zeros((1, self.corpus.dim), np.float32)
            for b in buckets or self.buckets:
                self.search(np.repeat(probe, b, axis=0), keff)
        return len(self._programs) - before

    def search(self, q: np.ndarray, k: int, mask: np.ndarray | None = None):
        """(ids u64[B, k], scores f32[B, k], valid bool[B, k]): the top-k
        rows per query in canonical (score desc, id asc) order; under-filled
        slots carry INVALID_ID / -inf / False."""
        q = np.ascontiguousarray(q, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.corpus.dim:
            raise ValueError(f"queries must be [B, {self.corpus.dim}], got {q.shape}")
        b, k = q.shape[0], int(k)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        ids = np.full((b, k), INVALID_ID, dtype=np.uint64)
        scores = np.full((b, k), -np.inf, dtype=np.float32)
        valid = np.zeros((b, k), dtype=bool)
        if b == 0 or self._n == 0:
            return ids, scores, valid
        if self.corpus.metric == "cosine":
            q = normalize_rows(q)
        q = quantize_sig12(q)
        if self._dp != q.shape[1]:
            q = np.pad(q, ((0, 0), (0, self._dp - q.shape[1])))
        bp = bucket_for(b, self.buckets)
        if bp != b:
            q = np.pad(q, ((0, bp - b), (0, 0)))
        keff = min(k, self._n)
        if mask is not None:
            mask = np.asarray(mask, dtype=bool)
            if mask.shape != (self._n,):
                raise ValueError(f"mask must be [{self._n}], got {mask.shape}")
        with self._book_lock:
            self._programs.add((bp, keff))
        qt = torch.from_numpy(q).to(self.device)
        mt = None if mask is None else torch.from_numpy(mask).to(self.device)
        if _resolve(self.impl, self.table2d) == "ref":
            s = paged_topk_score(self.table2d, qt, self._n, self._dp, impl="ref")
            if mt is not None:
                s = torch.where(mt[None, :], s, float("-inf"))
            vals, idx = canonical_topk(s[:b], keff)  # the bucket's padding rows are dropped
        else:
            exact = products_exact(operand_range(q), self._x_range)
            with self._book_lock:
                self.templates["fma" if exact else "mul_add"] += 1
            s = paged_topk_score(self.table2d, qt, self._n, self._dp, impl=self.impl,
                                 exact_products=exact)
            keys = paged_topk_select(s, b, keff, mt, impl=self.impl)  # real queries only
            vals, idx = topk_keys(keys.reshape(b, -1), keff)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        ok = vals > -np.inf
        ids[:, :keff] = np.where(ok, self.corpus.ids[np.clip(idx, 0, self._n - 1)], INVALID_ID)
        scores[:, :keff] = vals
        valid[:, :keff] = ok
        return ids, scores, valid


def numpy_topk_oracle(ids, vectors, q, k, metric="dot", mask=None):
    """INDEPENDENT reference: the retrieval-scoring spec in pure NumPy
    (no torch, no shared scoring code) — left-to-right f32 score
    accumulation, canonical cosine normalization, lexsort (score desc, id
    asc) selection. `mask` (optional bool) is aligned with the input row
    order. Returns the same (ids, scores, valid) triple as
    TopKIndex.search; bitwise equality against the served path is the
    retrieval parity claim."""
    ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
    x = np.ascontiguousarray(vectors, dtype=np.float32)
    # private copy: the cosine branch normalizes in place
    q = np.array(q, dtype=np.float32, order="C", copy=True)
    keep = np.ones(len(ids), dtype=bool) if mask is None else (
        np.asarray(mask, dtype=bool).copy()
    )
    order = np.argsort(ids, kind="stable")
    ids, x, keep = ids[order], x[order], keep[order]
    if metric == "cosine":
        for arr in (x, q):
            nrm2 = np.zeros(arr.shape[0], dtype=np.float32)
            for d in range(arr.shape[1]):
                nrm2 = nrm2 + arr[:, d] * arr[:, d]
            inv = np.ones_like(nrm2)
            ok = nrm2 > 0
            inv[ok] = np.float32(1.0) / np.sqrt(nrm2[ok])
            arr *= inv[:, None]
    elif metric != "dot":
        raise ValueError(f"unknown metric {metric!r}")
    # exact-product canon: truncate significands to 12 bits (own bit
    # expression of the corpus.py spec constant) so every product below
    # is exact in f32 and the sum order is the only rounding story
    x = (x.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)
    q = (
        np.ascontiguousarray(q).view(np.uint32) & np.uint32(0xFFFFF000)
    ).view(np.float32)
    b, n, k = q.shape[0], len(ids), int(k)
    out_ids = np.full((b, k), INVALID_ID, dtype=np.uint64)
    out_scores = np.full((b, k), -np.inf, dtype=np.float32)
    out_valid = np.zeros((b, k), dtype=bool)
    if n == 0:
        return out_ids, out_scores, out_valid
    scores = np.zeros((b, n), dtype=np.float32)
    for d in range(x.shape[1]):
        scores = scores + q[:, d][:, None] * x[:, d][None, :]
    scores = np.where(keep[None, :], scores, np.float32(-np.inf))
    take = min(k, n)
    for i in range(b):
        top = np.lexsort((ids, -scores[i]))[:take]
        s = scores[i][top]
        ok = s > -np.inf
        out_ids[i, :take] = np.where(ok, ids[top], INVALID_ID)
        out_scores[i, :take] = s
        out_valid[i, :take] = ok
    return out_ids, out_scores, out_valid


def merge_topk(parts, k: int):
    """Fuse per-shard top-k answers into the global top-k, per query.

    `parts` is a list of (ids, scores, valid) triples, each [B, k_s] and
    already in canonical (score desc, id asc) order, as TopKIndex.search
    returns them. A k-way heap merge in the same order makes the fleet
    answer bit-identical to a single-shard search over the union corpus:
    shard scores are per row, shards partition the rows, and each shard's
    own top k holds its share of the global top k."""
    if not parts:
        raise ValueError("merge_topk needs at least one shard answer")
    b = parts[0][0].shape[0]
    k = int(k)
    out_ids = np.full((b, k), INVALID_ID, dtype=np.uint64)
    out_scores = np.full((b, k), -np.inf, dtype=np.float32)
    out_valid = np.zeros((b, k), dtype=bool)

    def _stream(ids_row, scores_row, valid_row):
        # a def, not a genexp: a lazy genexp would close over the loop
        # variables by reference and read the last shard only
        for j, s in enumerate(scores_row):
            if valid_row[j]:
                yield (float(-s), int(ids_row[j]))

    for i in range(b):
        streams = [
            _stream(ids_p[i], scores_p[i], valid_p[i])
            for ids_p, scores_p, valid_p in parts
        ]
        for slot, (neg, nid) in enumerate(heapq.merge(*streams)):
            if slot >= k:
                break
            out_ids[i, slot] = np.uint64(nid)
            out_scores[i, slot] = np.float32(-neg)
            out_valid[i, slot] = True
    return out_ids, out_scores, out_valid
