"""Random-walk skip-gram pair generation, numpy only
(counterpart: euler_tpu/dataflow/walk.py:17-44).

`gen_pair` slides a [left_win, right_win] window over each walk and emits
(src, ctx) id pairs; padded (DEFAULT_ID) slots are masked out.
"""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.graph.store import DEFAULT_ID


def gen_pair(walks: np.ndarray, left_win: int = 1, right_win: int = 1):
    """walks u64 [n, L] → (pairs u64 [n * L * (left+right), 2], mask bool):
    a fixed shape for given (L, windows), so the embedding step keeps a
    static batch size."""
    walks = np.asarray(walks, dtype=np.uint64)
    n, length = walks.shape
    srcs, ctxs = [], []
    for off in range(-left_win, right_win + 1):
        if off == 0:
            continue
        lo, hi = max(0, -off), min(length, length - off)
        src = walks[:, lo:hi]
        ctx = walks[:, lo + off : hi + off]
        pad = length - (hi - lo)
        if pad:
            fill = np.full((n, pad), DEFAULT_ID, dtype=np.uint64)
            src = np.concatenate([src, fill], axis=1)
            ctx = np.concatenate([ctx, fill], axis=1)
        srcs.append(src)
        ctxs.append(ctx)
    src = np.concatenate(srcs, axis=1).reshape(-1)
    ctx = np.concatenate(ctxs, axis=1).reshape(-1)
    pairs = np.stack([src, ctx], axis=1)
    mask = (src != DEFAULT_ID) & (ctx != DEFAULT_ID)
    return pairs, mask
