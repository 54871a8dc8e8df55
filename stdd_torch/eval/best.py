"""Best-checkpoint evaluator for the dual encoder: clip → track → video
reports with per-technique breakdowns, threshold sweeps and bootstrap CIs.

Port of ``stdd_tpu/eval/best.py`` (``evaluate_checkpoint`` :199 and its
helpers; reference ``dualrun/cli/best.py``: evaluate_ckpt :319,
aggregate_video_predictions :518, compute_video_metrics :594,
sweep_threshold :617), with numpy in place of scikit-learn
(``train/metrics.py``): the same ``report_<pool>.json``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..train.metrics import stats_at_threshold, average_precision, roc_auc, roc_curve, sigmoid

AGG_MODES = ("track_mean", "track_median", "track_majority")
REAL_TOKENS = {"real", "original", "pristine", "authentic", "youtube-real", "celeb-real"}


def compute_global_metrics(y_true, y_pred, y_score=None) -> Dict:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    out = {
        "accuracy": float(np.mean(y_true == y_pred)),
        "precision": tp / (tp + fp) if tp + fp else 0.0,
        "recall": tp / (tp + fn) if tp + fn else 0.0,
        "f1": 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0,
        "confusion_matrix": [[tn, fp], [fn, tp]],
        "n": int(len(y_true)),
    }
    if y_score is not None and len(set(y_true.tolist())) > 1:
        out["auc_roc"] = roc_auc(y_true, np.asarray(y_score))
        out["pr_auc"] = average_precision(y_true, np.asarray(y_score))
    else:
        out["auc_roc"] = out["pr_auc"] = float("nan")
    return out


def per_tech_accuracy(techs: Sequence[str], y_true, y_pred) -> Dict[str, Dict]:
    """Per-technique clip accuracy (best.py:496)."""
    acc: Dict[str, Dict] = {}
    buckets = defaultdict(list)
    for t, yt, yp in zip(techs, y_true, y_pred):
        t = "REAL" if str(t).lower() in REAL_TOKENS else str(t)
        buckets[t].append(int(yt == yp))
    for t, hits in buckets.items():
        acc[t] = {"accuracy": float(np.mean(hits)), "n": len(hits)}
    return acc


def aggregate_videos(
    meta: Sequence[Tuple[str, str, str]],   # (tech, video_id, track_id) per clip
    y_true: np.ndarray,
    y_score: np.ndarray,
    prob_thresh: float,
    agg_mode: str = "track_median",
) -> Dict[str, Dict]:
    """Clip scores → per-track pooling → OR video verdict, video score = max
    track score; video keys namespaced per technique (best.py:518)."""
    assert agg_mode in AGG_MODES
    videos: Dict[str, Dict] = {}
    for (tech, vid, tid), y, p in zip(meta, y_true, y_score):
        tech = "REAL" if str(tech).lower() in REAL_TOKENS else str(tech)
        key = f"{tech}::{vid}"
        v = videos.setdefault(key, {"tracks": {}, "y_list": [], "tech": tech})
        t = v["tracks"].setdefault(str(tid), {"probs": [], "preds": [], "y": []})
        t["probs"].append(float(p))
        t["preds"].append(int(p >= prob_thresh))
        t["y"].append(int(y))
        v["y_list"].append(int(y))

    for key, v in videos.items():
        track_scores = []
        any_fake = False
        for t in v["tracks"].values():
            probs = np.asarray(t["probs"])
            preds = np.asarray(t["preds"])
            if agg_mode == "track_mean":
                score = float(probs.mean())
                pred = int(score >= prob_thresh)
            elif agg_mode == "track_median":
                score = float(np.median(probs))
                pred = int(score >= prob_thresh)
            else:  # majority
                pred = int((preds == 1).mean() >= 0.5)
                score = float(probs.mean())
            t["track_pred"], t["track_score"] = pred, score
            track_scores.append(score)
            any_fake |= pred == 1
        v["video_pred"] = int(any_fake)
        v["video_score"] = float(max(track_scores)) if track_scores else 0.0
        ys = np.asarray(v["y_list"])
        v["y_true"] = int(np.argmax(np.bincount(ys, minlength=2)))
    return videos


def video_metrics(videos: Dict[str, Dict]) -> Tuple[Dict, Dict[str, Dict]]:
    y = [v["y_true"] for v in videos.values()]
    p = [v["video_pred"] for v in videos.values()]
    s = [v["video_score"] for v in videos.values()]
    g = compute_global_metrics(y, p, s)
    per_tech = defaultdict(lambda: {"hits": 0, "n": 0})
    for v in videos.values():
        per_tech[v["tech"]]["n"] += 1
        per_tech[v["tech"]]["hits"] += int(v["video_pred"] == v["y_true"])
    pt = {
        t: {"accuracy": d["hits"] / max(d["n"], 1), "videos": d["n"]}
        for t, d in per_tech.items()
    }
    return g, pt


def sweep_threshold(
    y: np.ndarray, p: np.ndarray, mode: str = "acc",
    target_fpr: Optional[float] = None,
) -> float:
    """Grid / target-FPR operating point (best.py:617)."""
    y = np.asarray(y)
    p = np.asarray(p)
    if target_fpr is not None:
        fpr, tpr, thr = roc_curve(y, p)
        ok = fpr <= target_fpr
        if ok.any():
            # max TPR within the FPR budget (not the (0, 0, inf) point)
            i = int(np.argmax(np.where(ok, tpr, -1.0)))
        else:
            i = int(np.argmin(fpr))   # budget unreachable: least-FPR point
        t = float(thr[i])
        if not np.isfinite(t):
            # predict nothing positive: a finite threshold just above the top score
            t = float(np.nextafter(p.max(), np.inf)) if len(p) else 1.0
        return t
    best_t, best_score = 0.5, -1.0
    for t in np.linspace(0.05, 0.95, 19):
        preds = (p >= t).astype(int)
        if mode == "acc":
            score = float((preds == y).mean())
        elif mode in ("youden", "f1"):
            score = float(stats_at_threshold(p, y, float(t))[mode])
        else:
            raise ValueError(mode)
        if score > best_score:
            best_score, best_t = score, float(t)
    return best_t


def bootstrap_ci(
    y: np.ndarray, p: np.ndarray, B: int = 2000, seed: int = 0
) -> Dict[str, List[float]]:
    """Stratified bootstrap 95% CI for AUROC/AP (ds.py:149-156, best.py)."""
    rng = np.random.default_rng(seed)
    y = np.asarray(y)
    p = np.asarray(p)
    pos, neg = np.where(y == 1)[0], np.where(y == 0)[0]
    if not len(pos) or not len(neg):
        # single-class split: AUC is undefined in every resample — report
        # NaN CIs instead of crashing after the expensive eval already ran
        return {"B": B, "auc_ci95": [float("nan")] * 2,
                "ap_ci95": [float("nan")] * 2}
    aucs, aps = [], []
    for _ in range(B):
        bi = np.concatenate([
            rng.choice(pos, len(pos), True), rng.choice(neg, len(neg), True)
        ])
        aucs.append(roc_auc(y[bi], p[bi]))
        aps.append(average_precision(y[bi], p[bi]))
    return {
        "B": B,
        "auc_ci95": [float(x) for x in np.nanpercentile(aucs or [np.nan], [2.5, 97.5])],
        "ap_ci95": [float(x) for x in np.nanpercentile(aps or [np.nan], [2.5, 97.5])],
    }


def evaluate_checkpoint(
    model,
    params,
    data: Dict[str, np.ndarray],
    meta: Sequence[Tuple[str, str, str]],
    threshold: float = 0.5,
    temperature: float = 1.0,
    agg_mode: str = "track_median",
    sweep_mode: Optional[str] = None,
    target_fpr: Optional[float] = None,
    bootstrap: int = 0,
    out_path: Optional[str] = None,
    batch: int = 256,
) -> Dict:
    """Full evaluation report (best.py:319 evaluate_ckpt → report_<pool>.json)
    of ``model`` (a ``DualEncoderAU_LMK``) with ``params`` (its
    ``state_dict``, loaded first; None scores the model as it is)."""
    from ..train.engine_dual import collect_logits

    if params is not None:
        model.load_state_dict(params)
    logits, y = collect_logits(model, data, batch=batch)
    probs = sigmoid(logits / temperature)

    if sweep_mode or target_fpr is not None:
        threshold = sweep_threshold(y, probs, sweep_mode or "acc", target_fpr)

    preds = (probs >= threshold).astype(int)
    clip = compute_global_metrics(y, preds, probs)
    techs = [m[0] for m in meta]
    report = {
        "threshold": float(threshold),
        "temperature": float(temperature),
        "agg_mode": agg_mode,
        "clip_metrics": clip,
        "per_tech_clip_accuracy": per_tech_accuracy(techs, y, preds),
    }
    videos = aggregate_videos(meta, y, probs, threshold, agg_mode)
    vm, pt = video_metrics(videos)
    report["video_metrics"] = vm
    report["per_tech_video_accuracy"] = pt
    if bootstrap:
        report["bootstrap_clip"] = bootstrap_ci(y, probs, bootstrap)
        vy = [v["y_true"] for v in videos.values()]
        vs = [v["video_score"] for v in videos.values()]
        if len(set(vy)) > 1:
            report["bootstrap_video"] = bootstrap_ci(np.asarray(vy), np.asarray(vs), bootstrap)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report
