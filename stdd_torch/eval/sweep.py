"""Dataset × pool-method sweep runner (the reference's batch_eval.py).

Port of ``stdd_tpu/eval/sweep.py``, unchanged but for the package and
``roc_auc``, which is ``train/metrics.py``'s: numpy on
the host, and the port's engine (K1 on the card) for the scoring.

The reference subprocess-spawns its streaming harness once per
(dataset, pool_method) combination and collates summaries (+ own ROC/PR
implementation at batch_eval.py:122-184, wandb tables). Here the sweep runs
in-process: one engine per dataset, scored once, then re-aggregated for every
pool method — the expensive device work is shared across the sweep instead
of being recomputed per pool.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..runtime.scoring import POOL_METHODS, aggregate_video
# the tie-averaged rank ROC-AUC that stdd_tpu/eval/sweep.py:23 writes out again
from ..train.metrics import roc_auc


def pr_auc(y: np.ndarray, s: np.ndarray) -> float:
    """Step-wise AP over every score, ties not collapsed (batch_eval.py's
    own, stdd_tpu/eval/sweep.py:44); ``train/metrics.average_precision``
    collapses ties as scikit-learn does."""
    y = np.asarray(y)
    s = np.asarray(s, float)
    order = np.argsort(-s, kind="mergesort")
    y_sorted = y[order]
    tp = np.cumsum(y_sorted)
    fp = np.cumsum(1 - y_sorted)
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / max(y.sum(), 1)
    # step-wise integration (average_precision)
    ap = 0.0
    prev_r = 0.0
    for p, r in zip(prec, rec):
        ap += p * (r - prev_r)
        prev_r = r
    return float(ap)


def sweep_pools(
    track_scores_per_video: List[Dict[int, List[float]]],
    labels: Sequence[int],
    threshold: float,
    pool_methods: Sequence[str] = POOL_METHODS,
    out_dir: Optional[str] = None,
    dataset: str = "dataset",
) -> List[Dict]:
    """Re-aggregate per-video track scores under every pool method.

    ``track_scores_per_video``: one {tid: [clip scores]} dict per video —
    exactly what StreamingEngine accumulates; scoring is done ONCE and the
    pool sweep is pure host math.
    """
    rows = []
    for pool in pool_methods:
        y_pred, y_score = [], []
        for tracks in track_scores_per_video:
            v = aggregate_video(tracks, threshold=threshold, pool_method=pool)
            y_pred.append(int(v.video_fake))
            y_score.append(v.video_score)
        y = np.asarray(labels)
        y_pred = np.asarray(y_pred)
        acc = float((y_pred == y).mean()) if len(y) else float("nan")
        rows.append({
            "dataset": dataset,
            "pool_method": pool,
            "videos": len(y),
            "accuracy": acc,
            "auc_roc": roc_auc(y, np.asarray(y_score)),
            "pr_auc": pr_auc(y, np.asarray(y_score)),
            "threshold": threshold,
        })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "summary_all.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def run_sweep(
    engine,
    videos: Sequence,           # (path, label, dataset, subset) tuples
    threshold: float = 0.4,
    pool_methods: Sequence[str] = POOL_METHODS,
    out_dir: Optional[str] = None,
    max_frames: Optional[int] = None,
) -> List[Dict]:
    """Stream each video once (``.y4m``, ``harness.iter_video_frames``),
    then sweep pool methods over the captured track scores
    (batch_eval.py:187 semantics without the subprocess)."""
    from .harness import iter_video_frames

    per_video_tracks: List[Dict[int, List[float]]] = []
    labels: List[int] = []
    datasets = set()
    for vpath, gt, dset, _ in videos:
        engine.reset()
        for frame in iter_video_frames(vpath, max_frames):
            engine.step(frame)
        engine.flush()
        per_video_tracks.append({k: list(v) for k, v in engine.track_clip_scores.items()})
        labels.append(gt)
        datasets.add(dset)
    return sweep_pools(
        per_video_tracks, labels, threshold, pool_methods, out_dir,
        dataset=",".join(sorted(datasets)) or "dataset",
    )
