"""Association costs and thresholded Hungarian assignment — host plane.

Replaces the reference's ``lap.lapjv`` C solver and ``cython_bbox``
(``preprocessing/ByteTrack/matching.py:83,:97``) with scipy's Jonker-
Volgenant implementation plus a cost-limit extension; IoU keeps the
cython_bbox +1-pixel area convention so costs are bit-identical.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def bbox_ious_plus1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU over (x1, y1, x2, y2) boxes with the +1-pixel-area
    convention of cython_bbox.bbox_overlaps."""
    a = np.ascontiguousarray(a, dtype=float).reshape(-1, 4)
    b = np.ascontiguousarray(b, dtype=float).reshape(-1, 4)
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    iw = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(
        a[:, None, 0], b[None, :, 0]
    ) + 1
    ih = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(
        a[:, None, 1], b[None, :, 1]
    ) + 1
    iw = np.maximum(iw, 0)
    ih = np.maximum(ih, 0)
    inter = iw * ih
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def iou_cost(a_tlbr: Sequence, b_tlbr: Sequence) -> np.ndarray:
    """1 − IoU cost matrix (matching.py:117 iou_distance)."""
    return 1.0 - bbox_ious_plus1(np.asarray(a_tlbr), np.asarray(b_tlbr))


def fuse_score(cost: np.ndarray, det_scores: np.ndarray) -> np.ndarray:
    """Fold detector confidence into the IoU similarity
    (matching.py:217 fuse_score): cost' = 1 − (1 − cost) · score."""
    if cost.size == 0:
        return cost
    return 1.0 - (1.0 - cost) * np.asarray(det_scores)[None, :]


def linear_assignment(
    cost: np.ndarray, thresh: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian assignment where any pairing with cost > thresh is rejected.

    Same contract as lap.lapjv(extend_cost=True, cost_limit=thresh)
    (matching.py:83): returns (matches [K,2], unmatched_rows, unmatched_cols).
    Implemented by augmenting with per-row/per-column dummy nodes priced at
    thresh/2 so a real pairing wins iff its cost < thresh.
    """
    cost = np.asarray(cost, dtype=float)
    n, m = cost.shape
    if cost.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            np.arange(n, dtype=int),
            np.arange(m, dtype=int),
        )
    BIG = 1e9
    ext = np.full((n + m, n + m), BIG)
    ext[:n, :m] = cost
    ext[n:, m:] = 0.0
    idx = np.arange(max(n, m))
    ext[idx[:n], m + idx[:n]] = thresh / 2.0
    ext[n + idx[:m], idx[:m]] = thresh / 2.0
    rows, cols = linear_sum_assignment(ext)
    matches: List[List[int]] = []
    matched_r = np.zeros(n, dtype=bool)
    matched_c = np.zeros(m, dtype=bool)
    for r, c in zip(rows, cols):
        if r < n and c < m:
            matches.append([r, c])
            matched_r[r] = True
            matched_c[c] = True
    return (
        np.asarray(matches, dtype=int).reshape(-1, 2),
        np.where(~matched_r)[0],
        np.where(~matched_c)[0],
    )
