"""Metrics (counterpart: euler_tpu/nn/metrics.py:14-21)."""

from __future__ import annotations

import torch


def micro_f1(labels: torch.Tensor, logits: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Micro-averaged F1 for multi-label sigmoid heads."""
    preds = (logits > threshold).float()
    labels = labels.float()
    tp = torch.sum(preds * labels)
    fp = torch.sum(preds * (1 - labels))
    fn = torch.sum((1 - preds) * labels)
    return 2 * tp / torch.clamp_min(2 * tp + fp + fn, 1e-9)
