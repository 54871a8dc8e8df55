"""SCRFD face detector on the card (the second ONNX detector the reference
ships, ``altfreezing/checkpoints/scrfd_2.5g_bnkps.onnx``).

Port of ``stdd_tpu/models/scrfd.py``. Anchor-free decode (SCRFD,
arXiv:2105.04714): per stride s ∈ {8, 16, 32} each cell carries 2 anchors at
its corner ``(j·s, i·s)``; boxes are centre ∓ distance·s, the five keypoints
centre + offset·s. The raw heads run through the port's ONNX executor
(:class:`~stdd_torch.models.onnx_torch.OnnxModule`) on the detector's
device, the decode too; the greedy NMS
(:func:`~stdd_torch.ops.nms.nms_fixed`) runs on the host after one
device→host copy. Rows follow YuNet's ``(x, y, w, h, 5×(lx, ly), score)``
15-column convention, so the tracker and the engine take either detector.

The reference's ONNX file is not in the repository: the detector takes
its path, and ``utils/onnx_writer.py::scrfd_shaped_graph`` writes a
random-weight graph of its layout and output names.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.nms import nms_fixed
from .onnx_torch import OnnxModule

SCRFD_STRIDES = (8, 16, 32)
NUM_ANCHORS = 2
# the reference's weights, read from the port's assets once the file is in
# the repository
DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "assets", "scrfd_2.5g_bnkps.onnx")

# output tensor names by (kind, stride) of the shipped 2.5g_bnkps export
_OUT = {
    ("score", 8): "446", ("score", 16): "466", ("score", 32): "486",
    ("bbox", 8): "449", ("bbox", 16): "469", ("bbox", 32): "489",
    ("kps", 8): "452", ("kps", 16): "472", ("kps", 32): "492",
}


class SCRFDDetector:
    """``detect(frames_bgr)``: ``[B, H, W, 3]`` (or one ``[H, W, 3]``) uint8
    BGR, H and W divisible by 32 → ``(dets [B, top_k, 15], mask [B, top_k])``
    as numpy. The convolutions are float32 and follow
    ``torch.backends.cudnn.allow_tf32``."""

    def __init__(self, model_path: str = DEFAULT_MODEL, input_size: Tuple[int, int] = (320, 320),
                 conf_threshold: float = 0.5, nms_threshold: float = 0.4, top_k: int = 128,
                 device="cuda"):
        if not os.path.isfile(model_path):
            raise FileNotFoundError(
                f"SCRFD model {model_path} not found: pass the path of scrfd_2.5g_bnkps.onnx "
                "(or of a graph with its outputs, utils/onnx_writer.py::scrfd_shaped_graph)")
        self.device = torch.device(device)
        self.module = OnnxModule.from_file(model_path, device=self.device)
        self.input_size = input_size
        self.conf_threshold = float(conf_threshold)
        self.nms_threshold = float(nms_threshold)
        self.top_k = int(top_k)
        self._centers: Dict[Tuple[int, int, int], torch.Tensor] = {}

    def centers(self, w: int, h: int, s: int) -> torch.Tensor:
        """[gh·gw·NUM_ANCHORS, 2] anchor centres of stride ``s``, row-major,
        each cell's repeated for its anchors."""
        if (w, h, s) not in self._centers:
            gw, gh = w // s, h // s
            cx = torch.arange(gw, dtype=torch.float32, device=self.device).repeat(gh) * s
            cy = torch.arange(gh, dtype=torch.float32, device=self.device).repeat_interleave(gw) * s
            c = torch.stack([cx, cy], dim=1)
            self._centers[(w, h, s)] = c.repeat_interleave(NUM_ANCHORS, dim=0)
        return self._centers[(w, h, s)]

    def _rows(self, blob: torch.Tensor, W: int, H: int) -> torch.Tensor:
        """One frame's [1, 3, H, W] blob → [N, 15] rows over every anchor."""
        outs = self.module(blob)
        rows = []
        for s in SCRFD_STRIDES:
            sc = outs[_OUT[("score", s)]][:, 0]
            bb = outs[_OUT[("bbox", s)]] * s
            kk = outs[_OUT[("kps", s)]] * s
            c = self.centers(W, H, s)
            x1, y1 = c[:, 0] - bb[:, 0], c[:, 1] - bb[:, 1]
            x2, y2 = c[:, 0] + bb[:, 2], c[:, 1] + bb[:, 3]
            lk = (kk.reshape(-1, 5, 2) + c[:, None, :]).reshape(-1, 10)
            rows.append(torch.cat([torch.stack([x1, y1, x2 - x1, y2 - y1], dim=1), lk,
                                   sc[:, None]], dim=1))
        return torch.cat(rows, 0)

    def detect(self, frames_bgr) -> Tuple[np.ndarray, np.ndarray]:
        x = (frames_bgr if isinstance(frames_bgr, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(frames_bgr))).to(self.device)
        if x.dim() == 3:
            x = x[None]
        B, H, W, _ = x.shape
        # SCRFD's preprocess: RGB, (x − 127.5) / 128
        blob = ((x.flip(-1).float() - 127.5) / 128.0).permute(0, 3, 1, 2)
        with torch.inference_mode():
            rows = torch.stack([self._rows(blob[b:b + 1], W, H) for b in range(B)]).cpu()
        dets = np.zeros((B, self.top_k, 15), np.float32)
        mask = np.zeros((B, self.top_k), bool)
        for b in range(B):
            keep, ok = nms_fixed(rows[b, :, :4].contiguous(), rows[b, :, 14].contiguous(),
                                 self.nms_threshold, self.conf_threshold, self.top_k)
            n = int(ok.sum())
            dets[b, :n] = rows[b, keep[:n].long()].numpy()
            mask[b, :n] = True
        return dets, mask

    def detect_np(self, frame_bgr: np.ndarray) -> np.ndarray:
        dets, mask = self.detect(frame_bgr)
        return dets[0][mask[0]]
