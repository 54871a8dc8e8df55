"""Feature builders: raw per-clip landmarks/AUs → model-ready sequences.

Own copy of ``stdd_tpu/data/features.py`` (numpy only; the same bytes out
for the same inputs). Ports of the reference's converters:
- ``dualrun/data/make_lmk_features.py``: 66 MediaPipe FaceMesh keypoints ×2
  → 132-d per frame, nose-tip-centered, mouth-width-normalized, optional
  mouth-axis rotation invariance (``:138 extract``, ``:146 _rotate_to_mouth``)
- ``dualrun/data/make_au_features.py``: 12 AU activations + Δ + Δ² → 36-d
  (``:41 seq_au_to_features``)
- ``dualrun/data/compute_norm_stat.py``: streaming mean/std → norm_stats.npz
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# 66 keypoints (eyes+brows, outer lips) + 3 reference points, MediaPipe
# FaceMesh topology (make_lmk_features.py:39)
KEY_LANDMARKS_IDXS = [
    # left eye + brow
    33, 7, 163, 144, 145, 153, 154, 155, 133, 173, 157, 158, 159, 160, 161, 246,
    70, 63, 105, 66, 107, 55, 65, 52, 53, 46,
    # right eye + brow
    263, 249, 390, 373, 374, 380, 381, 382, 362, 398, 384, 385, 386, 387, 388, 466,
    300, 293, 334, 296, 336, 285, 295, 282, 283, 276,
    # outer lips
    61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291,
    # reference points
    1, 78, 308,
]
NOSE_TIP_IDX, MOUTH_LEFT_IDX, MOUTH_RIGHT_IDX = 1, 78, 308
REQ_MIN_LANDMARKS = max(KEY_LANDMARKS_IDXS) + 1  # 467 ≥ 309 used by reference
LMK_FEATURE_DIM = len(KEY_LANDMARKS_IDXS) * 2  # 132

# 68-point subset of the FaceMesh topology (test/af_realtime.py:106 MP68_IDX)
MP68_IDX = [
    10, 338, 297, 332, 284, 251, 389, 356, 454, 323, 361, 288, 397, 365, 379,
    378, 400, 70, 63, 105, 66, 107, 336, 296, 334, 293, 300, 168, 6, 197, 195,
    5, 4, 1, 19, 94, 33, 7, 163, 144, 145, 153, 263, 249, 390, 373, 374, 380,
    61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291, 308, 324, 318, 402,
    317, 14, 87, 178, 88,
]

# The 12 LibreFace action units, as the AU extractor emits them
# (models/au_resnet.py AU_KEYS / libreface_adapter.py)
AU_ORDER = ["AU01", "AU02", "AU04", "AU06", "AU07", "AU10", "AU12", "AU14",
            "AU15", "AU17", "AU23", "AU24"]


def infer_au_order(au_dicts) -> List[str]:
    """Stable AU key order from the data itself (make_au_features.py
    infer_au_order) — robust to either naming convention."""
    keys = set()
    for d in au_dicts:
        if isinstance(d, dict):
            keys.update(d.keys())
    return sorted(keys)


def _rotate_to_mouth(points: np.ndarray, ml: np.ndarray, mr: np.ndarray) -> np.ndarray:
    """Rotate so the mouth axis is horizontal (make_lmk_features.py:146)."""
    from math import atan2, cos, sin

    dx, dy = mr[0] - ml[0], mr[1] - ml[1]
    theta = atan2(dy, dx)
    c, s = cos(-theta), sin(-theta)
    R = np.array([[c, -s], [s, c]], np.float32)
    return (points @ R.T).astype(np.float32)


def lmk_frame_to_features(
    xy: np.ndarray, rot_invariant: bool = False
) -> Optional[np.ndarray]:
    """[N≥309, 2] FaceMesh points → 132-d normalized feature vector
    (make_lmk_features.py:152 _frame_to_features). ``None`` frames (a
    sentinel-flagged track's nulled landmarks) yield None, not an error."""
    try:
        xy = np.asarray(xy, np.float32)
    except (TypeError, ValueError):
        return None
    if xy.ndim != 2 or xy.shape[0] < REQ_MIN_LANDMARKS or xy.shape[1] < 2:
        return None
    xy = xy[:, :2]
    points = xy[KEY_LANDMARKS_IDXS]
    nose = xy[NOSE_TIP_IDX]
    ml = xy[MOUTH_LEFT_IDX]
    mr = xy[MOUTH_RIGHT_IDX]
    centered = points - nose
    scale = np.linalg.norm(ml - mr)
    if not np.isfinite(scale) or scale < 1e-8:
        return None
    normed = centered / (scale + 1e-6)
    if rot_invariant:
        normed = _rotate_to_mouth(
            normed, (ml - nose) / (scale + 1e-6), (mr - nose) / (scale + 1e-6)
        )
    return normed.reshape(-1).astype(np.float32)


def lmk_seq_to_features(seq, rot_invariant: bool = False) -> np.ndarray:
    """Sequence of per-frame landmark arrays → [T', 132]."""
    feats = []
    for frame in seq:
        v = lmk_frame_to_features(np.asarray(frame), rot_invariant)
        if v is not None:
            feats.append(v)
    if not feats:
        return np.zeros((0, LMK_FEATURE_DIM), np.float32)
    return np.stack(feats)


def au_dict_to_vec(d: Dict, order: Sequence[str]) -> np.ndarray:
    return np.array([float(d.get(k, 0.0)) for k in order], np.float32)


def au_seq_to_features(
    au_seq, order: Optional[Sequence[str]] = None,
    use_delta: bool = True, use_delta2: bool = True,
) -> np.ndarray:
    """[T, K] AU activations (or list of dicts) → [T, K·(1+Δ+Δ²)]
    (make_au_features.py:41)."""
    if len(au_seq) and isinstance(au_seq[0], dict):
        order = order or infer_au_order(au_seq) or AU_ORDER
        X = np.stack([au_dict_to_vec(d, order) for d in au_seq])
    else:
        X = np.asarray(au_seq, np.float32)
    feats = [X]
    d1 = np.diff(X, axis=0, prepend=X[:1])
    if use_delta:
        feats.append(d1)
    if use_delta2:
        feats.append(np.diff(d1, axis=0, prepend=d1[:1]))
    return np.concatenate(feats, axis=-1).astype(np.float32)


def process_clip_tree(
    base_dir: str,
    overwrite: bool = False,
    rot_invariant: bool = False,
    use_delta: bool = True,
    use_delta2: bool = True,
) -> Dict[str, int]:
    """Walk ``**/track_*/clip_*`` dirs converting saved ``landmarks.npy`` /
    ``aus.npy`` into ``lmk_features.npy`` / ``au_features.npy``
    (make_{lmk,au}_features.py process_tree)."""
    clips = glob.glob(os.path.join(base_dir, "**", "track_*", "clip_*"), recursive=True)
    stats = {"clips": len(clips), "lmk_ok": 0, "au_ok": 0, "skipped": 0}
    for c in clips:
        lmk_in = os.path.join(c, "landmarks.npy")
        au_in = os.path.join(c, "aus.npy")
        lmk_out = os.path.join(c, "lmk_features.npy")
        au_out = os.path.join(c, "au_features.npy")
        if os.path.isfile(lmk_in) and (overwrite or not os.path.isfile(lmk_out)):
            try:
                seq = np.load(lmk_in, allow_pickle=True)
                F = lmk_seq_to_features(seq, rot_invariant)
                if len(F):
                    np.save(lmk_out, F)
                    stats["lmk_ok"] += 1
            except Exception:
                stats["skipped"] += 1
        if os.path.isfile(au_in) and (overwrite or not os.path.isfile(au_out)):
            try:
                seq = np.load(au_in, allow_pickle=True)
                F = au_seq_to_features(list(seq), use_delta=use_delta, use_delta2=use_delta2)
                if len(F):
                    np.save(au_out, F)
                    stats["au_ok"] += 1
            except Exception:
                stats["skipped"] += 1
    return stats


class StreamingStats:
    """Streaming mean/std accumulator (compute_norm_stat.py:61 SumStats)."""

    def __init__(self, dim: int):
        self.n = 0
        self.s = np.zeros(dim, np.float64)
        self.s2 = np.zeros(dim, np.float64)

    def update(self, X: np.ndarray) -> None:
        X = np.asarray(X, np.float64).reshape(-1, self.s.shape[0])
        self.n += X.shape[0]
        self.s += X.sum(0)
        self.s2 += (X ** 2).sum(0)

    @property
    def mean(self) -> np.ndarray:
        return (self.s / max(self.n, 1)).astype(np.float32)

    @property
    def std(self) -> np.ndarray:
        var = self.s2 / max(self.n, 1) - (self.s / max(self.n, 1)) ** 2
        return np.sqrt(np.maximum(var, 0)).astype(np.float32)


def compute_norm_stats(base_dir: str, out_path: str, au_dim: int = 36, lmk_dim: int = 132) -> str:
    """Global z-score stats over a feature tree → npz (compute_norm_stat.py:102)."""
    au_stats = StreamingStats(au_dim)
    lmk_stats = StreamingStats(lmk_dim)
    for c in glob.glob(os.path.join(base_dir, "**", "track_*", "clip_*"), recursive=True):
        au_p = os.path.join(c, "au_features.npy")
        lm_p = os.path.join(c, "lmk_features.npy")
        try:
            if os.path.isfile(au_p):
                A = np.load(au_p)
                if A.ndim == 2 and A.shape[1] == au_dim:
                    au_stats.update(A)
            if os.path.isfile(lm_p):
                L = np.load(lm_p)
                if L.ndim == 2 and L.shape[1] == lmk_dim:
                    lmk_stats.update(L)
        except Exception:
            continue
    np.savez(
        out_path,
        au_mean=au_stats.mean, au_std=au_stats.std,
        lmk_mean=lmk_stats.mean, lmk_std=lmk_stats.std,
    )
    return out_path
