"""68-point facial-landmark CNN (MobileNetV2-GDConv, the reference demo
path's landmark model, ``test_tools/ct/face_alignment/basenet.py:58``).

Port of ``stdd_tpu/models/landmark_net.py``: a torchvision-layout
MobileNetV2 trunk → GDConv head (a 7×7 linear depthwise conv over the whole
map, then a 1×1 conv to 136 = 68·(x, y) outputs normalized to the crop).
The feed (``prepare_feed``, reference ``predictor.py:41``) is a 1.2× square
crop around the box, zero-padded at the frame's borders, resized to 224²
with the port's ``ops/align.py::resize_u8`` (bit-equal to cv2 5.0's
``INTER_LINEAR``, which JAX's feed calls) and ImageNet-normalized;
``reproject`` (:29) maps the points back to the frame. float32, NCHW inside.
The reference's weights are downloaded at run time by the reference; a
state dict in its torch layout loads through
:func:`gdconv_reference_to_flax`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.align import resize_u8
from ..utils.weights import flax_to_torch
from .i3d import batch_norm, flax_reset_

# torchvision MobileNetV2 inverted-residual settings: (expand, out, n, stride)
_IR_SETTINGS = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class _ConvBNReLU(nn.Module):
    def __init__(self, dim_in: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, relu6: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(dim_in, features, kernel, stride, (kernel - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.relu6 = relu6

    def forward(self, x, train: bool = False):
        x = batch_norm(self.bn, self.conv(x), train)
        return x.clamp(0.0, 6.0) if self.relu6 else x


class _InvertedResidual(nn.Module):
    def __init__(self, dim_in: int, features: int, stride: int, expand: int):
        super().__init__()
        hidden = dim_in * expand
        self.expand = _ConvBNReLU(dim_in, hidden, kernel=1) if expand != 1 else None
        self.depthwise = _ConvBNReLU(hidden, hidden, 3, stride, groups=hidden)
        self.project = _ConvBNReLU(hidden, features, kernel=1, relu6=False)
        self.residual = stride == 1 and dim_in == features

    def forward(self, x, train: bool = False):
        h = self.expand(x, train) if self.expand is not None else x
        h = self.project(self.depthwise(h, train), train)
        return x + h if self.residual else h


class MobileNetV2Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = _ConvBNReLU(3, 32, stride=2)
        self.n_blocks, dim = 0, 32
        for expand, out, n, stride in _IR_SETTINGS:
            for i in range(n):
                self.add_module(f"block{self.n_blocks}",
                                _InvertedResidual(dim, out, stride if i == 0 else 1, expand))
                self.n_blocks, dim = self.n_blocks + 1, out
        self.head_conv = _ConvBNReLU(dim, 1280, kernel=1)

    def forward(self, x, train: bool = False):
        x = self.stem(x, train)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, train)
        return self.head_conv(x, train)


class MobileNetGDConv(nn.Module):
    """Trunk → 7×7 linear depthwise GDConv → 1×1 → [B, 136]; ``forward``
    takes ``[B, 224, 224, 3]`` as the JAX module does."""

    def __init__(self, num_outputs: int = 136):
        super().__init__()
        self.base = MobileNetV2Trunk()
        self.gdconv = nn.Conv2d(1280, 1280, 7, groups=1280, bias=False)
        self.gdconv_bn = nn.BatchNorm2d(1280, eps=1e-5, momentum=0.1)
        self.out_conv = nn.Conv2d(1280, num_outputs, 1, bias=False)
        self.out_bn = nn.BatchNorm2d(num_outputs, eps=1e-5, momentum=0.1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults."""
        flax_reset_(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.base(x.float().permute(0, 3, 1, 2), train)          # [B, 1280, 7, 7]
        x = batch_norm(self.gdconv_bn, self.gdconv(x), train)
        x = batch_norm(self.out_bn, self.out_conv(x), train)
        return x.reshape(x.shape[0], -1)


IMAGENET_MEAN01 = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD01 = np.array([0.229, 0.224, 0.225], np.float32)


def prepare_feed(img_rgb: np.ndarray, box) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """1.2× square crop (zero-padded at the borders) → 224² ImageNet-
    normalized float32 [224, 224, 3], and the border-clamped crop box the
    reference reprojects with (predictor.py:41, :68 new_bbox)."""
    height, width = img_rgb.shape[:2]
    x1, y1, x2, y2 = [int(v) for v in box[:4]]
    w = x2 - x1 + 1
    h = y2 - y1 + 1
    size = int(min(w, h) * 1.2)
    cx = x1 + w // 2
    cy = y1 + h // 2
    x1 = cx - size // 2
    x2 = x1 + size
    y1 = cy - size // 2
    y2 = y1 + size
    dx, dy = max(0, -x1), max(0, -y1)
    x1c, y1c = max(0, x1), max(0, y1)
    edx, edy = max(0, x2 - width), max(0, y2 - height)
    x2c, y2c = min(width, x2), min(height, y2)
    crop = img_rgb[y1c:y2c, x1c:x2c]
    if dx > 0 or dy > 0 or edx > 0 or edy > 0:
        # cv2.copyMakeBorder(..., BORDER_CONSTANT, value=0)
        crop = np.pad(crop, ((dy, edy), (dx, edx)) + ((0, 0),) * (crop.ndim - 2))
    feed = resize_u8(crop, (224, 224)).astype(np.float32) / 255.0
    feed = (feed - IMAGENET_MEAN01) / IMAGENET_STD01
    return feed, (x1c, y1c, x2c, y2c)


def reproject(crop_box, landmarks_norm: np.ndarray) -> np.ndarray:
    """Normalized [68, 2] landmarks → frame coordinates (predictor.py:29)."""
    x1, y1, x2, y2 = crop_box
    out = np.asarray(landmarks_norm, np.float32).copy()
    out[:, 0] = out[:, 0] * (x2 - x1) + x1
    out[:, 1] = out[:, 1] * (y2 - y1) + y1
    return out


class LandmarkPredictor:
    """Batched 68-point predictor (predictor.py:113 batch_predict2):
    ``predict(img_rgb, boxes)`` → one [68, 2] float32 array a box. Weights:
    a flax variables tree (``variables``), else flax's initializers drawn
    from ``seed``; on ``device`` ("cuda" unless the caller asks for
    "cpu")."""

    def __init__(self, variables=None, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        model = MobileNetGDConv()
        if variables is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(flax_to_torch(variables, model, "GDConv landmarker"))
        self.model = model.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_torch_checkpoint(cls, path: str, device="cuda"):
        """The reference's ``MobileNet_GDConv`` state dict (a bare dict or
        ``{"state_dict": …}``). The file is unpickled: load only files you
        trust."""
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return cls(gdconv_reference_to_flax(sd), device=device)

    def predict(self, img_rgb: np.ndarray, boxes) -> List[np.ndarray]:
        feeds, crop_boxes = [], []
        for b in boxes:
            f, cb = prepare_feed(img_rgb, b)
            feeds.append(f)
            crop_boxes.append(cb)
        if not feeds:
            return []
        with torch.inference_mode():
            out = self.model(torch.from_numpy(np.stack(feeds)).to(self.device)).cpu().numpy()
        return [reproject(cb, o.reshape(68, 2)) for cb, o in zip(crop_boxes, out)]


def gdconv_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference ``MobileNet_GDConv`` state dict (torchvision's
    mobilenet_v2 features as ``base_net.0.features.*`` or
    ``pretrain_net.features.*``, and the ``linear7``/``linear1`` ConvBlocks)
    → the flax variables tree, as ``stdd_tpu/models/landmark_net.py::
    gdconv_torch_to_flax`` maps it."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    sd = {k.replace("module.", ""): np.asarray(v.detach().cpu().numpy()
                                              if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}

    def put(tree, path, v):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def conv(dst, src):
        put(params, dst + "/kernel", sd[src + ".weight"].transpose(2, 3, 1, 0))

    def bn(dst, src):
        put(params, dst + "/scale", sd[src + ".weight"])
        put(params, dst + "/bias", sd[src + ".bias"])
        put(stats, dst + "/mean", sd[src + ".running_mean"])
        put(stats, dst + "/var", sd[src + ".running_var"])

    f = "base_net.0.features" if any(k.startswith("base_net.0.features") for k in sd) \
        else "pretrain_net.features"
    conv("base/stem/conv", f + ".0.0")
    bn("base/stem/bn", f + ".0.1")
    for bi, ti in enumerate(range(1, 18)):   # features.1..17 are inverted residuals
        base = f + f".{ti}.conv"
        dst = f"base/block{bi}"
        if f"{base}.3.weight" in sd:         # expand variant: 0 expand, 1 dw, 2 conv, 3 bn
            conv(f"{dst}/expand/conv", base + ".0.0")
            bn(f"{dst}/expand/bn", base + ".0.1")
            conv(f"{dst}/depthwise/conv", base + ".1.0")
            bn(f"{dst}/depthwise/bn", base + ".1.1")
            conv(f"{dst}/project/conv", base + ".2")
            bn(f"{dst}/project/bn", base + ".3")
        else:                                # the first block: 0 dw, 1 conv, 2 bn
            conv(f"{dst}/depthwise/conv", base + ".0.0")
            bn(f"{dst}/depthwise/bn", base + ".0.1")
            conv(f"{dst}/project/conv", base + ".1")
            bn(f"{dst}/project/bn", base + ".2")
    conv("base/head_conv/conv", f + ".18.0")
    bn("base/head_conv/bn", f + ".18.1")
    conv("gdconv", "linear7.conv")
    bn("gdconv_bn", "linear7.bn")
    conv("out_conv", "linear1.conv")
    bn("out_bn", "linear1.bn")
    return {"params": params, "batch_stats": stats}
