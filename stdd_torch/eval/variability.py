"""Seed/variance evaluation methodology (the reference's ds.py).

For each seed: ratio-matched real/fake subsample of a per-video score table,
5-fold stratified per-fold metrics (mean ± sd), and a stratified bootstrap
(B=2000) 95% CI on the full pool (ds.py:116 run_one). :func:`run_seeds`
pools seeds into the ``summary_variability`` artifact the reference versions
under ``new_demo_test/results_suite``.

Port of ``stdd_tpu/eval/variability.py``, whose ``run_one`` calls
scikit-learn, which the card's machine lacks. Written out in numpy here:

- :func:`stratified_kfold_test_folds`, the fold of each sample as
  ``StratifiedKFold(n_splits, shuffle=True, random_state=seed)`` assigns it
  (scikit-learn 1.9 ``_make_test_folds``): the same folds, not only folds
  of the same sizes;
- macro F1, precision and recall with ``zero_division=0``
  (:func:`macro_prf`); ROC-AUC and AP from ``train/metrics.py``.
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from ..train.metrics import average_precision, roc_auc
from .best import bootstrap_ci


@dataclass
class VariabilityConfig:
    threshold: float = 0.4
    fake_per_real: float = 1.0
    bootstrap: int = 2000
    n_folds: int = 5
    seeds: Sequence[int] = (42, 43, 44, 45, 46)


def ratio_match_indices(y: np.ndarray, fake_per_real: float, rng) -> np.ndarray:
    """Subsample fakes to a fixed fakes-per-real ratio (ds.py pool step)."""
    pos = np.where(y == 1)[0]
    neg = np.where(y == 0)[0]
    n_fake = min(len(pos), int(round(len(neg) * fake_per_real)))
    pos_sel = rng.choice(pos, n_fake, replace=False)
    return np.concatenate([neg, pos_sel])


def stratified_kfold_test_folds(y: np.ndarray, n_splits: int, seed: int) -> np.ndarray:
    """The test fold (0 … n_splits−1) of each sample under scikit-learn's
    shuffled ``StratifiedKFold``: classes are numbered in order of first
    appearance; fold ``i`` takes ``bincount(sorted_classes[i::n_splits])``
    samples of each class; each class's block of fold numbers is shuffled
    by one ``RandomState(seed)`` in class order and written to that class's
    samples in their order. Raises, as scikit-learn does, with fewer
    samples than ``n_splits`` or when every class has fewer members."""
    y = np.asarray(y)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than "
                         f"the number of samples: n_samples={len(y)}.")
    _, first, inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    y_enc = class_perm[inv.reshape(-1)]
    n_classes = len(first)
    if np.all(n_splits > np.bincount(y_enc)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         "members in each class.")
    y_order = np.sort(y_enc)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(for_class)
        folds[y_enc == k] = for_class
    return folds


def macro_prf(y: np.ndarray, yhat: np.ndarray) -> Dict[str, float]:
    """Macro-averaged F1, precision and recall over the labels present in
    ``y`` or ``yhat``, a ratio with a zero denominator counting 0
    (scikit-learn's ``average="macro"``, ``zero_division=0``)."""
    f1s, precs, recs = [], [], []
    for c in np.union1d(y, yhat):
        tp = float(np.sum((yhat == c) & (y == c)))
        n_pred, n_true = float(np.sum(yhat == c)), float(np.sum(y == c))
        precs.append(tp / n_pred if n_pred else 0.0)
        recs.append(tp / n_true if n_true else 0.0)
        f1s.append(2 * tp / (n_pred + n_true) if n_pred + n_true else 0.0)
    return {"f1_macro": float(np.mean(f1s)), "precision_macro": float(np.mean(precs)),
            "recall_macro": float(np.mean(recs))}


def run_one(y: np.ndarray, scores: np.ndarray, seed: int, cfg: VariabilityConfig) -> Dict:
    rng = np.random.default_rng(seed)
    idx = ratio_match_indices(np.asarray(y), cfg.fake_per_real, rng)
    yt, st = np.asarray(y)[idx], np.asarray(scores)[idx]

    test_folds = stratified_kfold_test_folds(yt, cfg.n_folds, seed)
    per_fold = []
    for k in range(1, cfg.n_folds + 1):
        fold = np.flatnonzero(test_folds == k - 1)
        yf, sf = yt[fold], st[fold]
        if len(np.unique(yf)) < 2:
            # a class with fewer members than n_folds leaves this fold
            # single-class; AUC/AP are undefined there — record NaN instead
            # of crashing the whole seed suite after the expensive eval ran
            per_fold.append({"fold": k, "n": int(len(fold)),
                             "auc": float("nan"), "ap": float("nan"),
                             "f1_macro": float("nan"),
                             "precision_macro": float("nan"),
                             "recall_macro": float("nan"),
                             "single_class": True})
            continue
        yhat = (sf >= cfg.threshold).astype(int)
        per_fold.append({
            "fold": k, "n": int(len(fold)),
            "auc": roc_auc(yf, sf),
            "ap": average_precision(yf, sf),
            **macro_prf(yf, yhat),
        })

    def ms(key):
        vals = [f[key] for f in per_fold if not np.isnan(f[key])]
        if not vals:
            return {"mean": float("nan"), "sd": float("nan")}
        sd = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0
        return {"mean": float(np.mean(vals)), "sd": sd}

    return {
        "seed": seed,
        "n_pool": int(len(idx)),
        "per_fold": per_fold,
        "metrics_mean_sd": {k: ms(k) for k in ("auc", "ap", "f1_macro")},
        "bootstrap_ci": bootstrap_ci(yt, st, cfg.bootstrap, seed),
    }


def run_seeds(
    y: np.ndarray, scores: np.ndarray, cfg: Optional[VariabilityConfig] = None,
    out_dir: Optional[str] = None,
) -> Dict:
    cfg = cfg or VariabilityConfig()
    results = [run_one(y, scores, s, cfg) for s in cfg.seeds]
    aucs = [r["metrics_mean_sd"]["auc"]["mean"] for r in results]
    summary = {
        "seeds": list(cfg.seeds),
        "auc_mean": float(np.mean(aucs)),
        "auc_sd": float(np.std(aucs, ddof=1)) if len(aucs) > 1 else 0.0,
        "per_seed": results,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "summary_variability.json"), "w") as f:
            json.dump(summary, f, indent=1)
        with open(os.path.join(out_dir, "metrics_seeds.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["seed", "auc_mean", "auc_sd", "ap_mean",
                        "auc_ci_lo", "auc_ci_hi"])
            for r in results:
                w.writerow([
                    r["seed"],
                    f"{r['metrics_mean_sd']['auc']['mean']:.6f}",
                    f"{r['metrics_mean_sd']['auc']['sd']:.6f}",
                    f"{r['metrics_mean_sd']['ap']['mean']:.6f}",
                    f"{r['bootstrap_ci']['auc_ci95'][0]:.6f}",
                    f"{r['bootstrap_ci']['auc_ci95'][1]:.6f}",
                ])
    return summary


def load_per_video_csv(path: str):
    """Read a per_video.csv from the streaming harness (gt_label, video_score)."""
    ys, ss = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            ys.append(int(row["gt_label"]))
            ss.append(float(row["video_score"]))
    return np.asarray(ys), np.asarray(ss)
