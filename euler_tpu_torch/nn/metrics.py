"""Metrics (counterpart: euler_tpu/nn/metrics.py:9-65): accuracy, micro-F1,
pairwise AUC and the ranking metrics of the link-prediction heads.

The tie rules are the JAX package's: a positive's rank is 1 + the
negatives scoring strictly higher + half those scoring equal, and `auc`
counts a tie as half a win.
"""

from __future__ import annotations

import torch


def accuracy(labels: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    """Exact-match accuracy over hard predictions."""
    return (predictions == labels).float().mean()


def micro_f1(labels: torch.Tensor, logits: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Micro-averaged F1 for multi-label sigmoid heads."""
    preds = (logits > threshold).float()
    labels = labels.float()
    tp = torch.sum(preds * labels)
    fp = torch.sum(preds * (1 - labels))
    fn = torch.sum((1 - preds) * labels)
    return 2 * tp / torch.clamp_min(2 * tp + fp + fn, 1e-9)


def auc(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Pairwise-ranking AUC (probability a positive outranks a negative)."""
    labels = labels.reshape(-1).float()
    scores = scores.reshape(-1)
    pos = labels > 0.5
    diff = scores[:, None] - scores[None, :]
    pair = pos[:, None] & ~pos[None, :]
    wins = torch.where(pair, (diff > 0).float() + 0.5 * (diff == 0).float(),
                       torch.zeros_like(diff, dtype=torch.float32))
    return torch.sum(wins) / torch.clamp_min(torch.sum(pair).float(), 1.0)


def ranks_from_scores(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    """Rank of each positive among its negatives (1-based).
    pos_scores: [B]; neg_scores: [B, N]."""
    better = torch.sum((neg_scores > pos_scores[:, None]).float(), -1)
    ties = torch.sum((neg_scores == pos_scores[:, None]).float(), -1)
    return 1.0 + better + 0.5 * ties


def mrr(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    return torch.mean(1.0 / ranks_from_scores(pos_scores, neg_scores))


def mean_rank(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    return torch.mean(ranks_from_scores(pos_scores, neg_scores))


def hit_at_k(pos_scores: torch.Tensor, neg_scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.mean((ranks_from_scores(pos_scores, neg_scores) <= k).float())


METRICS = {
    "acc": accuracy,
    "f1": micro_f1,
    "auc": auc,
    "mrr": mrr,
    "mr": mean_rank,
}
