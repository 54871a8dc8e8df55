"""Eval metrics, aggregation, threshold selection and temperature scaling,
in numpy (and scipy) alone.

Port of ``stdd_tpu/train/metrics.py`` (reference dualrun/train/metrics.py,
thresholds.py:13, engine.py:131,162-230), whose JAX version calls
scikit-learn, which the card's machine lacks:

- ROC AUC as the Mann-Whitney statistic over ranks, tied scores sharing
  their mean rank (``roc_auc_score``'s value); NaN with one class absent;
- PR AUC as ``average_precision_score``'s step sum ``Σ (R_k − R_{k−1})·P_k``
  over the distinct scores, highest first; 0 without positives;
- F1, accuracy and the confusion counts at the threshold;
- :func:`roc_curve` as ``sklearn.metrics.roc_curve`` computes it (scores in
  descending stable order, one point per distinct score, collinear points
  dropped by the second difference of both counts, the ``(0, 0, inf)``
  point prepended), which :func:`threshold_from_roc` picks from;
- :func:`fit_temperature` with scipy's bounded scalar minimiser, as JAX's;
- the top-k helpers (:181-207) with the same stable descending order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def np_logit(p: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    p = np.clip(p, eps, 1 - eps)
    return np.log(p) - np.log1p(-p)


def ema_1d(x: np.ndarray, alpha: float) -> np.ndarray:
    """Causal EMA over the time axis of [B, T, D]."""
    if alpha <= 0:
        return x
    y = x.copy()
    for t in range(1, x.shape[1]):
        y[:, t] = alpha * y[:, t - 1] + (1 - alpha) * x[:, t]
    return y


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
    out = stats_at_threshold(probs, y, threshold)
    out.update(probs=probs, roc_auc=roc_auc(y, probs), pr_auc=average_precision(y, probs))
    return out


def stats_at_threshold(probs: np.ndarray, y: np.ndarray, t: float) -> Dict[str, Any]:
    y = np.asarray(y)
    preds = (probs >= t).astype(np.int64)
    tn = int(np.sum((y == 0) & (preds == 0)))
    fp = int(np.sum((y == 0) & (preds == 1)))
    fn = int(np.sum((y == 1) & (preds == 0)))
    tp = int(np.sum((y == 1) & (preds == 1)))
    TPR = tp / max(tp + fn, 1)
    FPR = fp / max(fp + tn, 1)
    return {"tn": tn, "fp": fp, "fn": fn, "tp": tp, "TPR": TPR, "FPR": FPR,
            "balacc": 0.5 * (TPR + 1 - FPR), "youden": TPR - FPR,
            "acc": float(np.mean(y == preds)),
            "f1": 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0}


def roc_curve(y: np.ndarray, s: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``sklearn.metrics.roc_curve(y, s)`` (positive label 1,
    ``drop_intermediate=True``): (fpr, tpr, thresholds), NaN rates for an
    absent class."""
    y = (np.asarray(y) == 1).astype(np.float64)
    s = np.asarray(s)
    order = np.argsort(s, kind="stable")[::-1]      # ties: the cumulative counts at a
    s, y = s[order], y[order]                        # tie's end do not depend on its order
    idx = np.r_[np.flatnonzero(np.diff(s)), len(y) - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thr = s[idx]
    if len(fps) > 2:
        keep = np.flatnonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thr = np.r_[np.inf, thr.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def threshold_from_roc(probs: np.ndarray, y: np.ndarray, metric: str = "youden",
                       target_fpr: Optional[float] = None) -> Tuple[float, Dict[str, Any]]:
    """The operating point on the ROC (thresholds.py:13): youden / balacc /
    acc / f1 / auc (closest to the corner), or the most TPR within
    ``target_fpr``; the ``(0, 0, inf)`` point becomes a threshold just
    above the largest score."""
    probs = np.asarray(probs)
    fpr, tpr, thr = roc_curve(y, probs)

    def realized(t: float) -> float:
        if not np.isfinite(t):
            return float(np.nextafter(np.max(probs), np.inf)) if len(probs) else 1.0
        return float(t)

    if target_fpr is not None:
        mask = fpr <= float(target_fpr)
        if not np.any(mask):
            idx = int(np.argmin(fpr))
        else:
            idx = int(np.arange(len(fpr))[mask][int(np.argmax(tpr[mask]))])
        t = realized(thr[idx])
        return t, stats_at_threshold(probs, y, t)
    if metric == "youden":
        idx = int(np.argmax(tpr - fpr))
    elif metric == "balacc":
        idx = int(np.argmax(0.5 * (tpr + 1 - fpr)))
    elif metric == "auc":
        mask = np.isfinite(thr)
        if not mask.any():
            idx = int(np.argmax(tpr - fpr))
        else:
            d2 = fpr[mask] ** 2 + (1 - tpr[mask]) ** 2
            idx = int(np.where(mask)[0][int(np.argmin(d2))])
    else:
        key = {"acc": "acc", "f1": "f1"}.get(metric, "youden")
        n_pos = float(np.sum(np.asarray(y) == 1))
        n_neg = float(len(y) - n_pos)
        tp = tpr * n_pos
        fp = fpr * n_neg
        if key == "acc":
            scores = (tp + (n_neg - fp)) / max(1.0, n_pos + n_neg)
        else:
            denom = 2 * tp + fp + (n_pos - tp)
            scores = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
        idx = int(np.argmax(scores))
    t = realized(thr[idx])
    return t, stats_at_threshold(probs, y, t)


def fit_temperature(val_logits: np.ndarray, val_y: np.ndarray) -> float:
    """Temperature T minimising BCE(sigmoid(z / T), y) + 1e-4·(T − 1)² over
    [0.25, 20] (engine.py:131), by scipy's bounded scalar minimiser; 1.0
    if it fails."""
    from scipy.optimize import minimize_scalar

    z = np.asarray(val_logits, np.float64)
    y = np.asarray(val_y, np.float64)

    def nll(T):
        T = np.clip(T, 1e-2, 1e3)
        zz = z / T
        bce = np.mean(np.maximum(zz, 0) - zz * y + np.log1p(np.exp(-np.abs(zz))))
        return bce + 1e-4 * (T - 1.0) ** 2

    try:
        res = minimize_scalar(nll, bounds=(0.25, 20.0), method="bounded")
        return float(np.clip(res.x, 0.25, 20.0))
    except (ValueError, FloatingPointError):
        return 1.0


# -- clip → person → video aggregation (engine.py:162-230) -------------------

def group_median_probs(logits: np.ndarray, ids: np.ndarray):
    """(sorted unique ids, each group's median prob, the stable sort order,
    the groups' starts in it)."""
    p = sigmoid(np.asarray(logits, np.float64))
    order = np.argsort(ids, kind="stable")
    ids_s, p_s = np.asarray(ids)[order], p[order]
    uniq, starts = np.unique(ids_s, return_index=True)
    meds = np.array([np.median(c) for c in np.split(p_s, starts[1:])])
    return uniq, meds, order, starts


def agg_person_median(logits: np.ndarray, y: np.ndarray, trk: np.ndarray):
    """Track-median prob and majority label."""
    _, meds, order, starts = group_median_probs(logits, trk)
    y_s = np.asarray(y)[order]
    y_person = np.array([float(c.mean() >= 0.5) for c in np.split(y_s, starts[1:])])
    return meds, y_person


def topks_correct(preds: np.ndarray, labels: np.ndarray, ks):
    """Number of top-k-correct predictions per k (reference
    slowfast/utils/metrics.py:9): ``preds`` [N, C] scores, ``labels`` [N]
    class indices; tied scores keep their class order."""
    preds = np.asarray(preds)
    labels = np.asarray(labels).reshape(-1)
    if preds.shape[0] != labels.shape[0]:
        raise ValueError("Batch dim of predictions and labels must match")
    top_inds = np.argsort(-preds, axis=1, kind="stable")[:, :max(ks)]
    correct = top_inds == labels[:, None]
    return [float(correct[:, :k].sum()) for k in ks]


def topk_accuracies(preds, labels, ks):
    """Top-k accuracy (%) per k (reference metrics.py:58)."""
    n = np.asarray(preds).shape[0]
    return [c / n * 100.0 for c in topks_correct(preds, labels, ks)]


def topk_errors(preds, labels, ks):
    """Top-k error (%) per k (reference metrics.py:46)."""
    n = np.asarray(preds).shape[0]
    return [(1.0 - c / n) * 100.0 for c in topks_correct(preds, labels, ks)]


def agg_video_noisyor(logits: np.ndarray, y: np.ndarray, trk: np.ndarray, vid: np.ndarray):
    """Track median → video noisy-OR over its tracks; a video is fake if any
    track is."""
    _, p_person, order, starts = group_median_probs(logits, trk)
    y_s = np.asarray(y)[order]
    vid_s = np.asarray(vid)[order]
    y_person = np.array([float(c.mean() >= 0.5) for c in np.split(y_s, starts[1:])])
    vid_person = np.array([c[0] for c in np.split(vid_s, starts[1:])])

    order2 = np.argsort(vid_person, kind="stable")
    v2, pp2, yp2 = vid_person[order2], p_person[order2], y_person[order2]
    _, starts_v = np.unique(v2, return_index=True)
    p_video, y_video = [], []
    for pc, yc in zip(np.split(pp2, starts_v[1:]), np.split(yp2, starts_v[1:])):
        pcl = np.clip(pc, 1e-6, 1 - 1e-6)
        p_video.append(1.0 - max(np.exp(np.sum(np.log1p(-pcl))), 1e-12))
        y_video.append(float(yc.max()))
    return np.asarray(p_video), np.asarray(y_video)
