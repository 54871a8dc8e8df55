"""RetinaFace (MobileNet-0.25) face detector, the reference demo's detector.

Port of ``stdd_tpu/models/retinaface.py`` (reference
``test_tools/ct/detection/alignment.py``): the MobileNetV1-0.25 backbone
(:119), the FPN (:76), three SSH context modules (:45), the class, box and
landmark heads (:156-196), the prior boxes (:344), the box and landmark
decode (:286/:299) and the NMS, here the port's host NMS
(:func:`~stdd_torch.ops.nms.nms_fixed`) after one device→host copy of the
decoded rows.

- Anchors: 2 per cell (``min_sizes`` pairs per stride 8/16/32), variance
  (0.1, 0.2), no clipping (cfg_mnet, alignment.py:381).
- The input is raw BGR minus (104, 117, 123), as the reference's
  ``batch_detect`` (alignment.py:535) feeds it; the network is float32,
  NCHW inside, and its outputs come back in the JAX module's order.
- The FPN's nearest upsample is ``jax.image.resize(..., "nearest")``'s:
  source index ``floor(((i + 0.5)·in) / out)`` in float32.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import nms_fixed
from .i3d import batch_norm, flax_reset_

CFG_MNET = {
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": (0.1, 0.2),
    "clip": False,
    "in_channel": 32,
    "out_channel": 64,
}

BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)


class ConvBN(nn.Module):
    """k×k conv → BN → optional LeakyReLU (alignment.py:12 conv_bn, :20
    conv_bn_no_relu); ``leaky=None`` is no activation, 0 a ReLU."""

    def __init__(self, dim_in: int, features: int, stride: int = 1, kernel: int = 3,
                 leaky: Optional[float] = 0.0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(dim_in, features, kernel, stride, kernel // 2, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.leaky = leaky

    def forward(self, x, train: bool = False):
        x = batch_norm(self.bn, self.conv(x), train)
        return x if self.leaky is None else F.leaky_relu(x, self.leaky)


class ConvDW(nn.Module):
    """Depthwise-separable block (alignment.py:34 conv_dw)."""

    def __init__(self, dim_in: int, features: int, stride: int):
        super().__init__()
        self.dw = ConvBN(dim_in, dim_in, stride=stride, leaky=0.1, groups=dim_in)
        self.pw = ConvBN(dim_in, features, kernel=1, leaky=0.1)

    def forward(self, x, train: bool = False):
        return self.pw(self.dw(x, train), train)


class MobileNetV1Quarter(nn.Module):
    """MobileNetV1 ×0.25 backbone returning the stage 1/2/3 features."""

    S1 = ((16, 1), (32, 2), (32, 1), (64, 2), (64, 1))
    S2 = (2, 1, 1, 1, 1, 1)
    S3 = (2, 1)

    def __init__(self):
        super().__init__()
        self.s1_conv = ConvBN(3, 8, stride=2, leaky=0.1)
        dim = 8
        for i, (f, s) in enumerate(self.S1):
            self.add_module(f"s1_dw{i}", ConvDW(dim, f, s))
            dim = f
        for i, s in enumerate(self.S2):
            self.add_module(f"s2_dw{i}", ConvDW(dim, 128, s))
            dim = 128
        for i, s in enumerate(self.S3):
            self.add_module(f"s3_dw{i}", ConvDW(dim, 256, s))
            dim = 256

    def forward(self, x, train: bool = False):
        x = self.s1_conv(x, train)
        for i in range(len(self.S1)):
            x = getattr(self, f"s1_dw{i}")(x, train)
        f1 = x
        for i in range(len(self.S2)):
            x = getattr(self, f"s2_dw{i}")(x, train)
        f2 = x
        for i in range(len(self.S3)):
            x = getattr(self, f"s3_dw{i}")(x, train)
        return f1, f2, x


class SSH(nn.Module):
    """Single-stage headless context module (alignment.py:45)."""

    def __init__(self, dim_in: int, out_channel: int):
        super().__init__()
        leaky = 0.1 if out_channel <= 64 else 0.0
        self.conv3x3 = ConvBN(dim_in, out_channel // 2, leaky=None)
        self.conv5x5_1 = ConvBN(dim_in, out_channel // 4, leaky=leaky)
        self.conv5x5_2 = ConvBN(out_channel // 4, out_channel // 4, leaky=None)
        self.conv7x7_2 = ConvBN(out_channel // 4, out_channel // 4, leaky=leaky)
        self.conv7x7_3 = ConvBN(out_channel // 4, out_channel // 4, leaky=None)

    def forward(self, x, train: bool = False):
        c3 = self.conv3x3(x, train)
        c5_1 = self.conv5x5_1(x, train)
        c5 = self.conv5x5_2(c5_1, train)
        c7 = self.conv7x7_3(self.conv7x7_2(c5_1, train), train)
        return F.relu(torch.cat([c3, c5, c7], dim=1))


def resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """An NCHW tensor resized to ``hw`` as ``jax.image.resize(...,
    "nearest")`` does: output row i reads row ``floor(((i + 0.5)·in) /
    out)``, computed in float32, and likewise for the columns."""
    for dim, n in ((2, hw[0]), (3, hw[1])):
        m = x.shape[dim]
        if m != n:
            idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
                           / np.float32(n)).astype(np.int64)
            x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


class FPN(nn.Module):
    def __init__(self, dims_in: Tuple[int, int, int], out_channels: int):
        super().__init__()
        leaky = 0.1 if out_channels <= 64 else 0.0
        for k, d in enumerate(dims_in, start=1):
            self.add_module(f"output{k}", ConvBN(d, out_channels, kernel=1, leaky=leaky))
        self.merge2 = ConvBN(out_channels, out_channels, leaky=leaky)
        self.merge1 = ConvBN(out_channels, out_channels, leaky=leaky)

    def forward(self, feats, train: bool = False):
        o1 = self.output1(feats[0], train)
        o2 = self.output2(feats[1], train)
        o3 = self.output3(feats[2], train)
        o2 = self.merge2(o2 + resize_nearest(o3, o2.shape[2:]), train)
        o1 = self.merge1(o1 + resize_nearest(o2, o1.shape[2:]), train)
        return [o1, o2, o3]


class RetinaFace(nn.Module):
    """Backbone → FPN → SSH → per-level heads. ``forward(x)``: ``x`` [B, H,
    W, 3] float (BGR minus the mean) → (bbox [B, N, 4], scores [B, N, 2]
    softmaxed, landmarks [B, N, 10])."""

    def __init__(self, out_channel: int = 64, num_anchors: int = 2):
        super().__init__()
        self.body = MobileNetV1Quarter()
        self.fpn = FPN((64, 128, 256), out_channel)
        for i in range(3):
            self.add_module(f"ssh{i + 1}", SSH(out_channel, out_channel))
        for i in range(3):
            self.add_module(f"bbox_head{i}", nn.Conv2d(out_channel, num_anchors * 4, 1))
            self.add_module(f"class_head{i}", nn.Conv2d(out_channel, num_anchors * 2, 1))
            self.add_module(f"ldm_head{i}", nn.Conv2d(out_channel, num_anchors * 10, 1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults."""
        flax_reset_(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.float().permute(0, 3, 1, 2)
        fpn = self.fpn(list(self.body(x, train)), train)
        bbox, cls, ldm = [], [], []
        for i, f in enumerate(fpn):
            f = getattr(self, f"ssh{i + 1}")(f, train)
            B = f.shape[0]
            for out, head, c in ((bbox, "bbox_head", 4), (cls, "class_head", 2),
                                 (ldm, "ldm_head", 10)):
                out.append(getattr(self, f"{head}{i}")(f).permute(0, 2, 3, 1).reshape(B, -1, c))
        return (torch.cat(bbox, 1), torch.softmax(torch.cat(cls, 1), dim=-1), torch.cat(ldm, 1))


def prior_boxes(image_hw: Tuple[int, int], cfg: Dict = CFG_MNET) -> np.ndarray:
    """Anchor centres and sizes normalized to [0, 1] (alignment.py:344
    PriorBox)."""
    h, w = image_hw
    anchors: List[float] = []
    for k, step in enumerate(cfg["steps"]):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i, j in product(range(fh), range(fw)):
            for min_size in cfg["min_sizes"][k]:
                anchors += [(j + 0.5) * step / w, (i + 0.5) * step / h, min_size / w, min_size / h]
    out = np.asarray(anchors, np.float32).reshape(-1, 4)
    if cfg["clip"]:
        out = np.clip(out, 0, 1)
    return out


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=CFG_MNET["variance"]) -> torch.Tensor:
    """(alignment.py:286 decode) → (x1, y1, x2, y2), normalized."""
    centers = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    sizes = priors[:, 2:] * torch.exp(loc[:, 2:] * variances[1])
    tl = centers - sizes / 2
    return torch.cat([tl, tl + sizes], dim=1)


def decode_landmarks(pre: torch.Tensor, priors: torch.Tensor,
                     variances=CFG_MNET["variance"]) -> torch.Tensor:
    """(alignment.py:299 decode_landm) → 5 points, normalized."""
    return torch.cat([priors[:, :2] + pre[:, 2 * i:2 * i + 2] * variances[0] * priors[:, 2:]
                      for i in range(5)], dim=1)


class RetinaFaceDetector:
    """Batched detector with the reference's postprocess (batch_detect at
    alignment.py:535: confidence 0.02 → NMS 0.4 with py_cpu_nms's +1 pixel
    areas → the top 750). ``detect(frames_bgr)``: ``[B, H, W, 3]`` (or one
    frame) uint8 BGR at ``image_hw`` → ``(dets [B, top_k, 15]: x1, y1, x2,
    y2, score, 10 landmark coordinates; mask [B, top_k])`` as numpy."""

    def __init__(self, state_dict, image_hw: Tuple[int, int], conf_threshold: float = 0.02,
                 nms_threshold: float = 0.4, top_k: int = 750, device="cuda"):
        self.device = torch.device(device)
        with torch.device(self.device):
            model = RetinaFace()
        model.load_state_dict(state_dict)
        self.model = model.eval().requires_grad_(False)
        self.image_hw = tuple(image_hw)
        self.conf_threshold, self.nms_threshold, self.top_k = conf_threshold, nms_threshold, top_k
        self.priors = torch.from_numpy(prior_boxes(self.image_hw)).to(self.device)
        self._mean = torch.from_numpy(BGR_MEAN).to(self.device)

    @classmethod
    def random_init(cls, image_hw=(240, 320), seed: int = 0, **kw):
        """Random weights with flax's initializers, drawn from ``seed``."""
        model = RetinaFace()
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return cls(model.state_dict(), image_hw, **kw)

    def detect(self, frames_bgr) -> Tuple[np.ndarray, np.ndarray]:
        x = (frames_bgr if isinstance(frames_bgr, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(frames_bgr))).to(self.device)
        if x.dim() == 3:
            x = x[None]
        h, w = self.image_hw
        with torch.inference_mode():
            loc, conf, ldm = self.model(x.float() - self._mean)
            scale_b = torch.tensor([w, h, w, h], dtype=torch.float32, device=self.device)
            scale_l = torch.tensor([w, h] * 5, dtype=torch.float32, device=self.device)
            rows = torch.stack([torch.cat([decode_boxes(lo, self.priors) * scale_b,
                                           co[:, 1:2],
                                           decode_landmarks(ld, self.priors) * scale_l], dim=1)
                                for lo, co, ld in zip(loc, conf, ldm)]).cpu()
        B = rows.shape[0]
        dets = np.zeros((B, self.top_k, 15), np.float32)
        mask = np.zeros((B, self.top_k), bool)
        for b in range(B):
            r = rows[b]
            xywh = torch.stack([r[:, 0], r[:, 1], r[:, 2] - r[:, 0], r[:, 3] - r[:, 1]], dim=1)
            keep, ok = nms_fixed(xywh, r[:, 4].contiguous(), self.nms_threshold,
                                 self.conf_threshold, self.top_k, plus1=True)
            n = int(ok.sum())
            dets[b, :n] = r[keep[:n].long()].numpy()
            mask[b, :n] = True
        return dets, mask
