"""KNN retrieval over inferred embeddings
(counterpart: euler_tpu/tools/knn.py).

An exact search: one matrix product of the queries against the whole
base, chunked, then the top k per query in (score desc, index asc) order.
No index build, no approximation. The product is a plain `torch.matmul`
(no hand-written kernel: the JAX package leaves it to XLA), so scores
agree with the JAX package's to f32 rounding, not bit for bit. On the
card TF32 is off unless the caller turned it on.

Usage:
    python -m euler_tpu_torch.tools.knn --model-dir DIR --k 10 [--query-ids 1 2 3] [--device cpu]
reads embedding_{w}.npy / ids_{w}.npy as `Estimator.infer` writes them.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.retrieval.topk import canonical_topk


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-9)


def knn_search(
    embeddings: np.ndarray,
    queries: np.ndarray,
    k: int = 10,
    metric: str = "ip",  # ip | l2 | cosine
    chunk: int = 1024,
    device=None,
):
    """Exact top-k: returns (indices [Q, k], scores [Q, k]) as numpy."""
    dev = resolve_device(device)
    base = torch.as_tensor(np.asarray(embeddings, np.float32), device=dev)
    if metric == "cosine":
        base = _unit_rows(base)
    base_sq = torch.sum(base * base, dim=1)
    queries = np.asarray(queries, np.float32)
    idxs, scores = [], []
    for i in range(0, len(queries), chunk):
        q = torch.as_tensor(queries[i : i + chunk], device=dev)
        if metric == "cosine":
            q = _unit_rows(q)
        sims = q @ base.T
        if metric == "l2":
            qsq = torch.sum(q * q, dim=1, keepdim=True)
            sims = -(qsq - 2 * sims + base_sq[None, :])
        s, ix = canonical_topk(sims, k)
        idxs.append(ix.cpu().numpy())
        scores.append(s.cpu().numpy())
    return np.concatenate(idxs), np.concatenate(scores)


def load_inferred(model_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate embedding_{w}.npy / ids_{w}.npy across workers."""
    embs, ids = [], []
    for path in sorted(glob.glob(os.path.join(model_dir, "embedding_*.npy"))):
        w = os.path.basename(path)[len("embedding_") : -len(".npy")]
        embs.append(np.load(path))
        ids.append(np.load(os.path.join(model_dir, f"ids_{w}.npy")))
    if not embs:
        raise FileNotFoundError(f"no embedding_*.npy under {model_dir}")
    return np.concatenate(ids), np.concatenate(embs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--metric", default="ip", choices=["ip", "l2", "cosine"])
    ap.add_argument("--query-ids", type=int, nargs="*", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    ids, embs = load_inferred(args.model_dir)
    if args.query_ids:
        pos = {int(i): r for r, i in enumerate(ids)}
        rows = [pos[q] for q in args.query_ids]
        queries = embs[rows]
    else:
        queries = embs[:5]
    idx, score = knn_search(embs, queries, args.k, args.metric, device=args.device)
    for qi, (row, sc) in enumerate(zip(idx, score)):
        pairs = ", ".join(f"{int(ids[r])}({s:.3f})" for r, s in zip(row, sc))
        print(f"query {qi}: {pairs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
