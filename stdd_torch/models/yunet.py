"""YuNet face detector on the card.

Port of ``stdd_tpu/models/yunet.py``. The reference executes
``face_detection_yunet_2023mar.onnx`` through cv2.FaceDetectorYN
(``preprocessing/yunet/yunet.py:47``; singleton service at
``test/af_realtime.py:123`` / ``TEST2.py:214``). Here the same weights run
as PyTorch ops (:class:`~stdd_torch.models.onnx_torch.OnnxModule`, cuDNN
convolutions) on a CUDA stream of the detector's own, so detection does not
queue behind the scorer's I3D forward on the default stream; the
anchor-free decode runs there too, and the greedy NMS
(:func:`~stdd_torch.ops.nms.nms_fixed`) runs on the host after one
device→host copy of the decoded rows. Detections come back as a padded
``[top_k, 15]`` array matching the reference's N×15 rows
``(x, y, w, h, 5×(lx, ly), score)``.

YuNet's export bakes batch 1 into its head reshapes (``[1, N, C]``); the
JAX package ``vmap``s a per-frame call, and this port calls the graph once
per frame, which gives the same rows.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DetectorConfig
from ..ops.nms import nms_fixed
from ..utils.spans import span
from .onnx_torch import OnnxModule

YUNET_STRIDES = (8, 16, 32)
# the reference's weights (OpenCV zoo / libfacedetection), read from the
# port's assets once the file is in the repository
DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "assets", "face_detection_yunet_2023mar.onnx")


def resize_linear_u8(frame: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of a uint8 [H, W, C] image with cv2's ``INTER_LINEAR``
    sample positions (half-pixel centres, edge clamp, no antialias), in
    float32, rounded half up to uint8 as cv2 rounds. cv2 weighs uint8
    pixels in 11-bit fixed point, so the two differ by at most 1 grey
    level."""
    x = frame.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=False)
    return torch.floor(y[0].permute(1, 2, 0) + 0.5).clamp_(0, 255).to(torch.uint8)


class YuNet:
    """Batched YuNet.

    ``detect(frames_bgr)`` takes ``[B, H, W, 3]`` (or one ``[H, W, 3]``)
    uint8 BGR, numpy or a tensor, with H and W divisible by 32, and returns
    ``(dets [B, top_k, 15] float32, mask [B, top_k] bool)`` as numpy
    arrays. ``model_path`` is an ONNX file (YuNet's, or a graph with its
    output contract); ``cfg`` gives the input size :func:`detect_scaled`
    resizes to, the score and NMS thresholds and ``top_k``.

    The convolutions are float32 and follow
    ``torch.backends.cudnn.allow_tf32``; the app turns TF32 off, the
    precision at which the detector on the card is held to the CPU."""

    def __init__(self, model_path: str = DEFAULT_MODEL, cfg: DetectorConfig = DetectorConfig(),
                 device="cuda"):
        self.device = torch.device(device)
        self.module = OnnxModule.from_file(model_path, device=self.device)
        self.cfg = cfg
        self.input_size = (cfg.input_w, cfg.input_h)   # (w, h) as in the reference
        self.conf_threshold = float(cfg.conf_threshold)
        self.nms_threshold = float(cfg.nms_threshold)
        self.top_k = int(cfg.top_k)
        self.stream = None
        if self.device.type == "cuda":
            # the weights were copied on the default stream; the detector's
            # stream must not read them before the copies land
            torch.cuda.current_stream(self.device).synchronize()
            self.stream = torch.cuda.Stream(self.device)
        self._grids: Dict[Tuple[int, int], Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = {}

    # -- decode (mirrors OpenCV FaceDetectorYNImpl::postProcess) -------------

    def _grid(self, w: int, h: int) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
        if (w, h) not in self._grids:
            grids = {}
            for s in YUNET_STRIDES:
                gw, gh = w // s, h // s
                r = torch.arange(gh, dtype=torch.float32, device=self.device)
                c = torch.arange(gw, dtype=torch.float32, device=self.device)
                grids[s] = (c.repeat(gh), r.repeat_interleave(gw))
            self._grids[(w, h)] = grids
        return self._grids[(w, h)]

    def _decode_one(self, outs: Dict[str, torch.Tensor], w: int, h: int):
        """One frame's head outputs → (boxes [N,4] xywh, scores [N],
        landmarks [N,10]) over every anchor of the three strides."""
        grids = self._grid(w, h)
        boxes, scores, lmks = [], [], []
        for s in YUNET_STRIDES:
            cls = torch.clamp(outs[f"cls_{s}"][0, :, 0], 0.0, 1.0)
            obj = torch.clamp(outs[f"obj_{s}"][0, :, 0], 0.0, 1.0)
            score = torch.sqrt(cls * obj)
            bbox = outs[f"bbox_{s}"][0]
            kps = outs[f"kps_{s}"][0]
            c, r = grids[s]
            cx = (c + bbox[:, 0]) * s
            cy = (r + bbox[:, 1]) * s
            bw = torch.exp(bbox[:, 2]) * s
            bh = torch.exp(bbox[:, 3]) * s
            x1 = cx - bw / 2
            y1 = cy - bh / 2
            lx = (kps[:, 0::2] + c[:, None]) * s
            ly = (kps[:, 1::2] + r[:, None]) * s
            boxes.append(torch.stack([x1, y1, bw, bh], dim=1))
            scores.append(score)
            lmks.append(torch.stack([lx, ly], dim=2).reshape(-1, 10))
        return torch.cat(boxes, 0), torch.cat(scores, 0), torch.cat(lmks, 0)

    def _detect_impl(self, frames: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        B, H, W, _ = frames.shape
        blob = frames.float().permute(0, 3, 1, 2)      # NCHW, raw 0-255 BGR
        rows = []
        with torch.inference_mode():
            for b in range(B):
                boxes, scores, lmks = self._decode_one(self.module(blob[b:b + 1]), W, H)
                rows.append(torch.cat([boxes, lmks, scores[:, None]], dim=1))
            rows = torch.stack(rows).cpu()             # one device→host copy
        dets = np.zeros((B, self.top_k, 15), np.float32)
        mask = np.zeros((B, self.top_k), bool)
        for b in range(B):
            keep, ok = nms_fixed(rows[b, :, :4], rows[b, :, 14], self.nms_threshold,
                                 self.conf_threshold, self.top_k)
            n = int(ok.sum())
            dets[b, :n] = rows[b, keep[:n].long()].numpy()
            mask[b, :n] = True
        return dets, mask

    def _on_device(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def detect(self, frames_bgr) -> Tuple[np.ndarray, np.ndarray]:
        # the frames and every kernel of the detection on the detector's
        # stream (none on the CPU); the rows' copy to the host waits for them
        with torch.cuda.stream(self.stream):
            frames = self._on_device(frames_bgr)
            if frames.dim() == 3:
                frames = frames[None]
            return self._detect_impl(frames)

    def detect_np(self, frame_bgr) -> np.ndarray:
        """Single-frame convenience mirroring the reference ``YuNet.infer``
        (preprocessing/yunet/yunet.py:87): returns the valid N×15 rows."""
        dets, mask = self.detect(frame_bgr)
        return dets[0][mask[0]]


def detect_scaled(det: YuNet, frame_bgr, det_size: Optional[int] = None) -> np.ndarray:
    """Fixed-size detection scaled back to frame coordinates: upload the
    frame, resize it on the detector's device (:func:`resize_linear_u8`,
    cv2 ``INTER_LINEAR`` positions) to ``det_size``² or, by default, to the
    detector's ``input_size``, detect, and rescale the [N, 15] rows' box
    and landmark columns to the frame (the reference's resize-and-rescale
    block, TEST2.py:502 / preprocessing_parallel.py:246)."""
    w, h = (det_size, det_size) if det_size is not None else det.input_size
    if w % 32 or h % 32:
        # the graph's stride-8/16/32 grids need divisible inputs
        raise ValueError(f"det_size must be a multiple of 32 (got {w}x{h})")
    H, W = frame_bgr.shape[:2]
    with span("stdd.detector.detect"):
        with torch.cuda.stream(det.stream):
            small = resize_linear_u8(det._on_device(frame_bgr), h, w)
        rows = det.detect_np(small)
    if rows.size:
        rows = rows.copy()
        rows[:, 0:14:2] *= W / w
        rows[:, 1:14:2] *= H / h
    return rows
