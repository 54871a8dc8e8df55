"""Clip → track → video score aggregation (reference layer L6).

Host-plane numpy: these reductions run over a handful of scores per track —
the heavy lifting (clip scoring) already happened on device.

Sources in the reference:
- ``_pool_track`` with 8 methods — TEST2.py:636
- ``score_with_stability`` IQR damping — TEST2.py:627
- QA low-quality override via score quantiles — TEST2.py:699-760
- video verdict = OR over per-person labels, score = max — TEST2.py:763-766
- realtime hysteresis (median of last 5, 0.75/0.65) — af_realtime.py:351-358
- meeting verdict (p80 of running scores, ≥128 frames) — app_realtime.py:75
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

POOL_METHODS = (
    "mean",
    "median",
    "logit_median",
    "topk",
    "topk_median",
    "percentile",
    "trimmed_mean",
    "adaptive",
)


def pool_track(
    scores: Sequence[float],
    method: str = "median",
    topk_ratio: float = 0.2,
    percentile_p: float = 80.0,
    trim_ratio: float = 0.2,
) -> float:
    """Pool a track's clip scores into one number (TEST2.py:636 _pool_track)."""
    s = np.asarray(scores, float)
    if s.size == 0:
        return 0.0
    if method == "mean":
        return float(np.mean(s))
    if method == "median":
        return float(np.median(s))
    if method == "logit_median":
        se = np.clip(s, 1e-6, 1 - 1e-6)
        med = np.median(np.log(se / (1 - se)))
        return float(1 / (1 + np.exp(-med)))
    if method == "topk":
        k = max(1, int(np.ceil(topk_ratio * s.size)))
        return float(np.mean(np.sort(s)[-k:]))
    if method == "topk_median":
        k = max(1, int(np.ceil(topk_ratio * s.size)))
        return float(np.median(np.sort(s)[-k:]))
    if method == "percentile":
        p = float(np.clip(percentile_p, 0.0, 100.0))
        return float(np.percentile(s, p))
    if method == "trimmed_mean":
        t = float(np.clip(trim_ratio, 0.0, 0.49))
        ss = np.sort(s)
        n = ss.size
        a = int(n * t)
        b = max(a + 1, n - a)
        return float(np.mean(ss[a:b]))
    if method == "adaptive":
        iqr = np.percentile(s, 75) - np.percentile(s, 25)
        if iqr < 0.15:
            p = float(np.clip(percentile_p, 0.0, 100.0))
            return float(np.percentile(s, p))
        se = np.clip(s, 1e-6, 1 - 1e-6)
        med = np.median(np.log(se / (1 - se)))
        return float(1 / (1 + np.exp(-med)))
    return float(np.median(s))


def score_with_stability(scores: Sequence[float], base: float) -> float:
    """IQR-based damping of unstable tracks (TEST2.py:627): penalize only when
    the 85-25 spread is large and the median is not already high."""
    s = np.asarray(scores, float)
    if s.size == 0:
        return 0.0
    iqr = np.percentile(s, 85) - np.percentile(s, 25)
    if iqr > 0.25 and np.median(s) < 0.85:
        return base * (0.85 ** (iqr / 0.25))
    return base


def score_quantiles(scores: Sequence[float]) -> Optional[Dict[str, float]]:
    s = np.asarray(scores, float)
    if s.size == 0:
        return None
    qs = np.percentile(s, [10, 25, 50, 75, 90])
    return {"q10": qs[0], "q25": qs[1], "q50": qs[2], "q75": qs[3], "q90": qs[4]}


@dataclass
class VideoVerdict:
    video_fake: bool
    video_score: float
    per_person_scores: Dict[int, float]
    per_person_labels: Dict[int, int]
    raw_scores: Dict[int, float]
    track_quantiles: Dict[int, Dict[str, float]]
    low_quality: bool


def aggregate_video(
    track_clip_scores: Dict[int, Sequence[float]],
    threshold: float,
    pool_method: str = "median",
    topk_ratio: float = 0.2,
    percentile_p: float = 80.0,
    trim_ratio: float = 0.2,
    min_clips: int = 1,
    disable_penalty: bool = False,
    low_quality: bool = False,
    qa_q75_thr: float = 0.9,
    qa_q90_thr: float = 0.95,
) -> VideoVerdict:
    """Full end-of-video decision (TEST2.py:699-766): per-track pooling with
    stability penalty, QA override on low-quality videos, OR verdict, max
    score for AUC."""
    raw_scores: Dict[int, float] = {}
    per_person: Dict[int, float] = {}
    quants: Dict[int, Dict[str, float]] = {}

    for tid, scores in track_clip_scores.items():
        if len(scores) < min_clips:
            continue
        raw = pool_track(scores, pool_method, topk_ratio, percentile_p, trim_ratio)
        pen = raw if disable_penalty else score_with_stability(scores, raw)
        raw_scores[tid] = float(raw)
        per_person[tid] = float(pen)
        q = score_quantiles(scores)
        if q:
            quants[tid] = q

    labels_std = {tid: int(per_person[tid] > threshold) for tid in per_person}
    labels_qa = {tid: 0 for tid in per_person}
    if low_quality:
        for tid in per_person:
            q = quants.get(tid)
            labels_qa[tid] = int(
                bool(q and (q["q75"] >= qa_q75_thr or q["q90"] >= qa_q90_thr))
            )
    labels = {tid: int(labels_std[tid] or labels_qa[tid]) for tid in per_person}
    return VideoVerdict(
        video_fake=any(v == 1 for v in labels.values()),
        video_score=float(max(raw_scores.values())) if raw_scores else 0.0,
        per_person_scores=per_person,
        per_person_labels=labels,
        raw_scores=raw_scores,
        track_quantiles=quants,
        low_quality=low_quality,
    )


class HysteresisState:
    """Per-track fake/real flip-flop over the median of the last ``window``
    clip scores (af_realtime.py:351-358)."""

    def __init__(self, t_high: float = 0.75, t_low: float = 0.65, window: int = 5):
        self.t_high = t_high
        self.t_low = t_low
        self.window = window
        self.hist: Dict[int, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=window)
        )
        self.fake: Dict[int, bool] = {}

    def update(self, tid: int, score: float) -> bool:
        self.hist[tid].append(float(score))
        sm = float(np.median(self.hist[tid]))
        state = self.fake.get(tid, False)
        if not state and sm >= self.t_high:
            state = True
        elif state and sm < self.t_low:
            state = False
        self.fake[tid] = state
        return state

    def drop(self, tid: int) -> None:
        self.hist.pop(tid, None)
        self.fake.pop(tid, None)


def decide_meeting_fake(
    running_scores: Dict[int, Sequence[float]],
    frames_seen: Dict[int, int],
    threshold: float,
    min_frames: int = 128,
    percentile: float = 80.0,
) -> bool:
    """Meeting-level verdict (app_realtime.py:75): any track with enough
    frames whose p80 running score clears the threshold."""
    for tid, scores in running_scores.items():
        if frames_seen.get(tid, 0) < min_frames or len(scores) == 0:
            continue
        if float(np.percentile(np.asarray(scores, float), percentile)) >= threshold:
            return True
    return False
