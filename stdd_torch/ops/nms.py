"""Fixed-capacity greedy NMS and IoU matrices.

Port of ``stdd_tpu/ops/nms.py``, which replaces cv2.dnn.NMSBoxes (inside
cv2.FaceDetectorYN, reference ``preprocessing/yunet/yunet.py``) and the
NumPy ``py_cpu_nms`` (reference ``test_tools/ct/detection/alignment.py:313``).
The output keeps the JAX contract: ``(keep [max_out] int32, mask [max_out]
bool)``, survivors in score order, padded with 0 where the mask is False.

The JAX function scans all ``max_out`` steps over a precomputed N×N IoU
matrix (a ``lax.scan`` must have a static length). Here the loop runs in
numpy on the host, over the anchors above the score threshold (the others
are never picked, and whether they are suppressed changes nothing), and
stops at the first step that finds no candidate left; the JAX scan leaves
its state unchanged from that step on, so the outputs are the same. Each
step computes only the winner's IoU row, with the same float32 expressions
as the matrix row it replaces. On an H100 the same loop in torch ops on the
card, where every step waits for the device, took 13.9 ms against 0.88 ms
for this loop (``PERF.md`` §6), so the detector copies its rows to the host
once and ``nms_fixed`` refuses device tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def iou_matrix_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU for [N,4]/[M,4] boxes in (x, y, w, h). Matches the
    integer-free float IoU of cv2.dnn.NMSBoxes."""
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix1 = torch.maximum(ax1[:, None], bx1[None, :])
    iy1 = torch.maximum(ay1[:, None], by1[None, :])
    ix2 = torch.minimum(ax2[:, None], bx2[None, :])
    iy2 = torch.minimum(ay2[:, None], by2[None, :])
    iw = torch.clamp(ix2 - ix1, min=0.0)
    ih = torch.clamp(iy2 - iy1, min=0.0)
    inter = iw * ih
    area_a = torch.clamp(a[:, 2], min=0.0) * torch.clamp(a[:, 3], min=0.0)
    area_b = torch.clamp(b[:, 2], min=0.0) * torch.clamp(b[:, 3], min=0.0)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def iou_matrix_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU for (x1, y1, x2, y2) boxes (ByteTrack's ``ious``
    convention without its +1 pixel areas, which live in
    ``track/matching.py``)."""
    aw = torch.stack([a[:, 0], a[:, 1], a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]], dim=1)
    bw = torch.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], dim=1)
    return iou_matrix_xywh(aw, bw)


def _nms_host(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
              score_threshold: float, max_out: int, plus1: bool):
    """The greedy loop in numpy float32 over the above-threshold anchors."""
    keep = np.zeros((max_out,), np.int32)
    mask = np.zeros((max_out,), bool)
    cand = np.flatnonzero(scores > np.float32(score_threshold))
    b = boxes[cand]
    sc = scores[cand]
    x1, y1, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    x2, y2 = x1 + w, y1 + h
    if plus1:
        area = (w + np.float32(1.0)) * (h + np.float32(1.0))
    else:
        area = np.maximum(w, np.float32(0.0)) * np.maximum(h, np.float32(0.0))
    one = np.float32(1.0 if plus1 else 0.0)
    alive = np.ones((cand.size,), bool)
    for i in range(min(max_out, cand.size)):
        masked = np.where(alive, sc, np.float32(-np.inf))
        j = int(np.argmax(masked))              # first index on ties, as jnp.argmax
        if not masked[j] > -np.inf:
            break
        keep[i] = cand[j]
        mask[i] = True
        iw = np.maximum(np.minimum(x2[j], x2) - np.maximum(x1[j], x1) + one, np.float32(0.0))
        ih = np.maximum(np.minimum(y2[j], y2) - np.maximum(y1[j], y1) + one, np.float32(0.0))
        inter = iw * ih
        union = area[j] + area - inter
        iou = np.divide(inter, union, out=np.zeros_like(inter), where=union > 0)
        alive &= ~(iou > np.float32(iou_threshold))
        alive[j] = False
    return keep, mask


def nms_fixed(
    boxes: torch.Tensor,     # [N, 4] (x, y, w, h) float32, on the CPU
    scores: torch.Tensor,    # [N]
    iou_threshold: float,
    score_threshold: float,
    max_out: int,
    plus1: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed output capacity, on the host: score filter,
    then take the best live box and suppress its overlaps (itself included)
    until ``max_out`` are kept or none is left. Returns ``(keep_idx
    [max_out] int32, keep_mask [max_out] bool)``. ``plus1`` switches to
    py_cpu_nms's integer-pixel IoU. Tensors on a device are refused: copy
    the rows to the host first."""
    if boxes.device.type != "cpu" or scores.device.type != "cpu":
        raise ValueError(f"nms_fixed runs on the host; got {boxes.device} boxes and "
                         f"{scores.device} scores (copy them to the CPU first)")
    keep, mask = _nms_host(boxes.numpy(), scores.numpy(), iou_threshold, score_threshold,
                           max_out, plus1)
    return torch.from_numpy(keep), torch.from_numpy(mask)
