"""AVA-style spatio-temporal detection evaluation (CSV → per-class AP/mAP).

Rebuild of ``slowfast/utils/ava_eval_helper.py`` (``read_csv`` :53,
``read_exclusions`` :90, ``read_labelmap`` :108, ``evaluate_ava`` :136,
``write_results`` :288). The reference delegates AP computation to the
ActivityNet ``object_detection_evaluation`` package; here the PASCAL-VOC
style AP (precision envelope over recall, IoU-matched greedy assignment at
0.5) is implemented directly in numpy — same metric, no vendored evaluator.

CSV rows: ``video_id,timestamp,x1,y1,x2,y2,action_id[,score]`` with
normalized [0,1] box coordinates (AVA convention).

The code of the JAX package's ``stdd_tpu/eval/ava.py``: it is numpy.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


def make_image_key(video_id: str, timestamp) -> str:
    """frame key (reference :48): video + 4-digit timestamp."""
    return f"{video_id},{int(timestamp):04d}"


def read_labelmap(path: str) -> Tuple[Dict[int, str], Set[int]]:
    """pbtxt-ish labelmap: lines with ``name: "..."`` and ``id: N``
    (reference :108)."""
    names: Dict[int, str] = {}
    name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("name:"):
                name = line.split('"')[1]
            elif line.startswith(("id:", "label_id:")):
                cid = int(line.split(":")[1])
                names[cid] = name or str(cid)
    return names, set(names)


def read_exclusions(path: Optional[str]) -> Set[str]:
    """Set of excluded image keys ``video,timestamp`` (reference :90)."""
    if not path:
        return set()
    with open(path) as f:
        return {make_image_key(*line.strip().split(",")[:2])
                for line in f if line.strip()}


def read_csv(path: str, class_whitelist: Optional[Set[int]] = None,
             load_score: bool = False):
    """→ (boxes, labels, scores) keyed by image key (reference :53).
    Boxes stored y1,x1,y2,x2 like the reference does internally."""
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with open(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            assert len(row) in (7, 8), f"bad AVA row: {row}"
            key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = map(float, row[2:6])
            cid = int(row[6])
            if class_whitelist is not None and cid not in class_whitelist:
                continue
            boxes[key].append([y1, x1, y2, x2])
            labels[key].append(cid)
            scores[key].append(float(row[7]) if load_score and len(row) == 8 else 1.0)
    return boxes, labels, scores


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    y1 = np.maximum(a[:, None, 0], b[None, :, 0])
    x1 = np.maximum(a[:, None, 1], b[None, :, 1])
    y2 = np.minimum(a[:, None, 2], b[None, :, 2])
    x2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


def _voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """All-point interpolated AP (precision envelope), the metric the
    ActivityNet evaluator computes for AVA."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_ava(
    gt_boxes, gt_labels,
    det_boxes, det_labels, det_scores,
    excluded_keys: Optional[Set[str]] = None,
    iou_thresh: float = 0.5,
    categories: Optional[Dict[int, str]] = None,
) -> Dict[str, float]:
    """Frame-level mAP@IoU over AVA-keyed dicts (reference evaluate_ava :136
    + run_evaluation :173). → {"mAP": .., "AP/<class>": ..}."""
    excluded_keys = excluded_keys or set()
    # per class: list of (score, is_tp) over all frames + total gt count
    per_class: Dict[int, List[Tuple[float, bool]]] = defaultdict(list)
    n_gt: Dict[int, int] = defaultdict(int)

    keys = set(gt_boxes) | set(det_boxes)
    for key in keys:
        if key in excluded_keys:
            continue
        g_b = np.asarray(gt_boxes.get(key, []), np.float32).reshape(-1, 4)
        g_l = np.asarray(gt_labels.get(key, []), np.int64)
        d_b = np.asarray(det_boxes.get(key, []), np.float32).reshape(-1, 4)
        d_l = np.asarray(det_labels.get(key, []), np.int64)
        d_s = np.asarray(det_scores.get(key, []), np.float32)
        for c in set(g_l.tolist()) | set(d_l.tolist()):
            gb = g_b[g_l == c]
            n_gt[c] += len(gb)
            order = np.argsort(-d_s[d_l == c])
            db = d_b[d_l == c][order]
            ds = d_s[d_l == c][order]
            if len(db) == 0:
                continue
            taken = np.zeros(len(gb), bool)
            ious = _iou_matrix(db, gb) if len(gb) else np.zeros((len(db), 0))
            for i in range(len(db)):
                j = int(np.argmax(ious[i])) if ious.shape[1] else -1
                tp = ious.shape[1] > 0 and ious[i, j] >= iou_thresh and not taken[j]
                if tp:
                    taken[j] = True
                per_class[c].append((float(ds[i]), bool(tp)))

    out: Dict[str, float] = {}
    aps = []
    # iterate classes WITH ground truth (not classes with detections): a
    # class the detector never fired on must score AP=0, not vanish from
    # the mean — the ActivityNet evaluator counts it
    for c in sorted(n_gt):
        if n_gt[c] == 0:
            continue
        rows = per_class.get(c, [])
        if not rows:
            name = (categories or {}).get(c, str(c))
            out[f"AP/{name}"] = 0.0
            aps.append(0.0)
            continue
        rows.sort(key=lambda r: -r[0])
        tps = np.asarray([r[1] for r in rows], np.float64)
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(1.0 - tps)
        rec = tp_cum / n_gt[c]
        prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        ap = _voc_ap(rec, prec)
        name = (categories or {}).get(c, str(c))
        out[f"AP/{name}"] = ap
        aps.append(ap)
    out["mAP"] = float(np.mean(aps)) if aps else 0.0
    return out


def evaluate_ava_from_files(
    labelmap: str, groundtruth: str, detections: str,
    exclusions: Optional[str] = None, iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """File-level entry point (reference :126)."""
    categories, whitelist = read_labelmap(labelmap)
    excluded = read_exclusions(exclusions)
    g_b, g_l, _ = read_csv(groundtruth, whitelist)
    d_b, d_l, d_s = read_csv(detections, whitelist, load_score=True)
    return evaluate_ava(g_b, g_l, d_b, d_l, d_s, excluded, iou_thresh, categories)


def write_results(detections, path: str) -> None:
    """Write AVA-format detection rows (reference :288): detections is an
    iterable of (video_id, timestamp, [x1,y1,x2,y2], action_id, score)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for vid, ts, box, cid, score in detections:
            w.writerow([vid, int(ts), *[f"{v:.6f}" for v in box], int(cid),
                        f"{score:.6f}"])
