"""Validation metrics of the I3D trainer in numpy alone.

Port of ``sigmoid`` and ``metrics_from_logits``
(``stdd_tpu/train/metrics.py:31``; reference dualrun/train/metrics.py),
whose JAX version calls scikit-learn, which the card's machine lacks:

- ROC AUC as the Mann-Whitney statistic over ranks, tied scores sharing
  their mean rank (``roc_auc_score``'s value); NaN with one class absent;
- PR AUC as ``average_precision_score``'s step sum ``Σ (R_k − R_{k−1})·P_k``
  over the distinct scores, highest first; 0 without positives;
- F1, accuracy and the confusion counts at the threshold.

The other metrics of that module (thresholds, temperature, aggregation)
wait for the dual-encoder family.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _ranks(s: np.ndarray) -> np.ndarray:
    """1-based ranks of ``s``, ties sharing their mean rank."""
    order = np.argsort(s, kind="mergesort")
    sorted_s = s[order]
    starts = np.flatnonzero(np.r_[True, sorted_s[1:] != sorted_s[:-1]])
    ends = np.r_[starts[1:], len(s)]
    mean_rank = (starts + ends + 1) / 2.0                      # ranks starts+1 .. ends
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.repeat(mean_rank, ends - starts)
    return ranks


def roc_auc(y: np.ndarray, s: np.ndarray) -> float:
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((_ranks(s)[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision(y: np.ndarray, s: np.ndarray) -> float:
    pos = (y == 1).astype(np.float64)
    n_pos = pos.sum()
    if n_pos == 0:
        return 0.0
    order = np.argsort(-s, kind="mergesort")
    s_sorted, pos = s[order], pos[order]
    last = np.r_[np.flatnonzero(s_sorted[1:] != s_sorted[:-1]), len(s) - 1]
    tps = np.cumsum(pos)[last]
    precision = tps / (last + 1.0)
    recall = tps / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def metrics_from_logits(logits: np.ndarray, y: np.ndarray,
                        threshold: float = 0.5) -> Dict[str, Any]:
    y = np.asarray(y)
    probs = np.nan_to_num(sigmoid(np.asarray(logits)), nan=0.5, posinf=1.0, neginf=0.0)
    preds = (probs >= threshold).astype(np.int64)
    tn = int(np.sum((y == 0) & (preds == 0)))
    fp = int(np.sum((y == 0) & (preds == 1)))
    fn = int(np.sum((y == 1) & (preds == 0)))
    tp = int(np.sum((y == 1) & (preds == 1)))
    tpr = tp / max(tp + fn, 1)
    fpr = fp / max(fp + tn, 1)
    return {
        "tn": tn, "fp": fp, "fn": fn, "tp": tp,
        "TPR": tpr, "FPR": fpr,
        "balacc": 0.5 * (tpr + (1 - fpr)),
        "youden": tpr - fpr,
        "acc": float(np.mean(y == preds)),
        "f1": 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0,
        "probs": probs,
        "roc_auc": roc_auc(y, probs),
        "pr_auc": average_precision(y, probs),
    }
