"""ResUNet — the 3D encoder-decoder mask predictor family.

Port of ``stdd_tpu/models/unet3d.py`` (the reference's ResUNet zoo,
``slowfast/models/video_model_builder.py:1128`` ResUNet … ``:2513``
ResUNetStrong; decoder blocks ``slowfast/models/unet_helper.py:6,:46``):

- the I3D encoder cut after s4, with no temporal pool, so the skips stay on
  the stem's grid;
- per-label decoders: upsample(s4)⊕s3 → t4 → upsample⊕s2 → t3 → ⊕s1 →
  mask head + sigmoid, a per-pixel mask per label;
- the verdict: the masks' spatial mean ×100 → Linear(1, k) (→ sigmoid).

:data:`RESUNET_VARIANTS` tabulates the seven variants' switches and
:func:`make_resunet` builds one by name. Activations are NCTHW in the
model's ``dtype`` over float32 parameters; BatchNorm is flax's in train mode
(``models/i3d.py::batch_norm``); the masks and the verdict are float32.
Module names follow the flax tree, flax's automatic names included
(``t4_rotate.conv1.Conv_0``, ``….BatchNorm_0``), for
``utils/weights.py::flax_to_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import I3DConfig
from .i3d import (STAGE_DEPTH, Conv3dBN, ResBlock, ResStage, VideoStem, batch_norm,
                  cast_conv, flax_reset_)


def upsample_nearest(x: torch.Tensor, time: bool = False) -> torch.Tensor:
    """2× nearest-neighbour upsample of an NCTHW tensor in space (and
    optionally in time): each value repeated, as the reference's
    ``F.interpolate`` default (video_model_builder.py:1312-1323)."""
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return x.repeat_interleave(2, dim=2) if time else x


class Conv3dReLU(nn.Module):
    """conv → BN → ReLU (reference unet_helper.py:6)."""

    def __init__(self, dim_in: int, features: int, kernel: Tuple[int, int, int] = (3, 3, 3),
                 use_batchnorm: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv3d(dim_in, features, kernel, padding=tuple(k // 2 for k in kernel),
                                bias=not use_batchnorm)
        self.BatchNorm_0 = nn.BatchNorm3d(features, eps=1e-5, momentum=0.1) \
            if use_batchnorm else None

    def forward(self, x, train: bool = False):
        x = cast_conv(self.Conv_0, x)
        if self.BatchNorm_0 is not None:
            x = batch_norm(self.BatchNorm_0, x, train)
        return F.relu(x)


class DecoderBlock(nn.Module):
    """Decoder block on the concatenated skip. ``kind``: ``"heavy"`` (two
    conv-BN-ReLU, unet_helper.py:46), ``"light"`` (one, :74), ``"res"`` (two
    bottleneck residual blocks of inner width ``features // 2``, :119)."""

    def __init__(self, dim_in: int, features: int, kind: str = "heavy"):
        super().__init__()
        self.kind = kind
        if kind == "res":
            common = dict(dim_out=features, dim_inner=features // 2, temp_kernel_size=3,
                          stride=1, zero_init_final_bn=False, bn_eps=1e-5, bn_momentum=0.1)
            self.conv1 = ResBlock(dim_in=dim_in, **common)
            self.conv2 = ResBlock(dim_in=features, **common)
            return
        self.conv1 = Conv3dReLU(dim_in, features)
        self.conv2 = Conv3dReLU(features, features) if kind == "heavy" else None

    def forward(self, x, train: bool = False):
        if self.kind == "res":
            return self.conv2(self.conv1(x, train=train), train=train)
        x = self.conv1(x, train)
        return self.conv2(x, train) if self.conv2 is not None else x


class MaskHead(nn.Module):
    """Per-label 1×1×1 mask head: one conv (``hidden=0``), or
    conv → BN → ReLU → conv (the LightFix/Strong MLP head,
    video_model_builder.py:1735/2531)."""

    def __init__(self, dim_in: int, hidden: int = 0):
        super().__init__()
        self.conv1 = nn.Conv3d(dim_in, hidden or 1, 1)
        self.bn = nn.BatchNorm3d(hidden, eps=1e-5, momentum=0.1) if hidden else None
        self.conv2 = nn.Conv3d(hidden, 1, 1) if hidden else None

    def forward(self, x, train: bool = False):
        x = cast_conv(self.conv1, x)
        if self.bn is None:
            return x
        return cast_conv(self.conv2, F.relu(batch_norm(self.bn, x, train)))


@dataclasses.dataclass(frozen=True)
class ResUNetVariant:
    """One reference variant's switches."""

    labels: Tuple[str, ...]
    decoder: str            # DecoderBlock.kind
    t4_features: int        # decoder widths at width_per_group=64
    t3_features: int
    head_hidden: int        # MaskHead.hidden (0 = plain conv + sigmoid)
    class_features: int     # Linear out features
    class_sigmoid: bool
    class_per_label: bool   # reshape (B, n_labels, -1) instead of (B, -1)
    detach_input: bool      # no gradient into the input (Common/Common2/Strong)


# The 7 reference ResUNet variants (widths at width_per_group=64), as
# stdd_tpu/models/unet3d.py:151 tabulates them.
RESUNET_VARIANTS = {
    "resunet": ResUNetVariant(("rotate", "light"), "heavy", 512, 256, 0, 1, True, False, False),
    "light": ResUNetVariant(("rotate", "light"), "light", 256, 128, 0, 1, True, False, False),
    "lightfix": ResUNetVariant(("rotate", "light", "skip"), "light", 256, 128,
                               64, 1, True, False, False),
    "continus": ResUNetVariant(("all",), "light", 256, 128, 64, 1, True, False, False),
    "common": ResUNetVariant(("rotate", "light", "skip"), "light", 256, 128,
                             64, 2, False, True, True),
    "common2": ResUNetVariant(("rotate", "light", "skip"), "light", 256, 128,
                              64, 1, True, True, True),
    "strong": ResUNetVariant(("rotate", "light", "skip"), "res", 512, 256,
                             128, 1, True, True, True),
}


class ResUNet3D(nn.Module):
    """I3D encoder + per-label UNet decoders → per-pixel manipulation masks
    and a verdict.

    ``forward(x)``: ``x`` [B, T, H, W, 3] → ``(masks [B, T, H/4, W/4,
    n_labels] float32, verdict)``. ``freeze_backbone=True`` stops gradients
    at the encoder's outputs (the reference's ``get_detach_var``). ``labels``
    overrides the variant's label list. Decoder and head widths scale with
    ``width_per_group / 64``."""

    def __init__(self, cfg: Optional[I3DConfig] = None,
                 variant: ResUNetVariant = RESUNET_VARIANTS["resunet"],
                 labels: Optional[Tuple[str, ...]] = None, light: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg or I3DConfig()
        var = RESUNET_VARIANTS["light"] if light else variant
        self.cfg, self.variant, self.compute_dtype = c, var, dtype
        self.labels = tuple(labels or var.labels)
        depths = STAGE_DEPTH[c.depth]
        w = c.width_per_group
        inner = c.num_groups * w
        common = dict(zero_init_final_bn=True, bn_eps=c.bn_eps, bn_momentum=c.bn_momentum)
        self.s1 = VideoStem(c.input_channels, w, c.temp_kernel[0][0], c.bn_eps, c.bn_momentum)
        self.s2 = ResStage(w, w * 4, inner, c.temp_kernel[1], depths[0],
                           c.num_block_temp_kernel[0], c.spatial_strides[0], **common)
        self.s3 = ResStage(w * 4, w * 8, inner * 2, c.temp_kernel[2], depths[1],
                           c.num_block_temp_kernel[1], c.spatial_strides[1], **common)
        self.s4 = ResStage(w * 8, w * 16, inner * 4, c.temp_kernel[3], depths[2],
                           c.num_block_temp_kernel[2], c.spatial_strides[2], **common)
        scale = max(w // 64, 1) if w >= 64 else w / 64.0
        t4_f = max(int(var.t4_features * scale), 8)
        t3_f = max(int(var.t3_features * scale), 8)
        hidden = max(int(var.head_hidden * scale), 8) if var.head_hidden else 0
        for label in self.labels:   # dual_define deep-copies per label (:1295)
            self.add_module(f"t4_{label}", DecoderBlock(w * 8 + w * 16, t4_f, var.decoder))
            self.add_module(f"t3_{label}", DecoderBlock(w * 4 + t4_f, t3_f, var.decoder))
            self.add_module(f"conv1x1_{label}", MaskHead(w + t3_f, hidden))
        self.linear = nn.Linear(1, var.class_features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers: MSRA for the encoder's and the
        residual decoders' convolutions, flax's defaults elsewhere."""
        flax_reset_(self, generator)
        for m in self.modules():
            if isinstance(m, Conv3dBN):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False, freeze_backbone: bool = False):
        var = self.variant
        x = x.to(self.compute_dtype)
        if var.detach_input:
            x = x.detach()     # the reference detaches the input (:2240)
        x = x.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
        x1 = self.s1(x, train)
        x2 = self.s2(x1, train=train)
        x3 = self.s3(x2, train=train)
        x4 = self.s4(x3, train=train)
        if freeze_backbone:
            x1, x2, x3, x4 = (t.detach() for t in (x1, x2, x3, x4))
        up4 = torch.cat([x3, upsample_nearest(x4)], dim=1)
        masks = []
        for label in self.labels:
            h = getattr(self, f"t4_{label}")(up4, train)
            h = torch.cat([x2, upsample_nearest(h)], dim=1)
            h = getattr(self, f"t3_{label}")(h, train)
            h = torch.cat([x1, h], dim=1)
            m = getattr(self, f"conv1x1_{label}")(h, train)
            masks.append(torch.sigmoid(m.float()))
        masks = torch.cat(masks, dim=1)                       # [B, n_labels, T, H/4, W/4]
        # the verdict: label-major rows of the per-frame means (:1331-1334)
        pooled = masks.mean(dim=(3, 4)).reshape(-1, 1) * 100.0
        out = self.linear(pooled)
        B = masks.shape[0]
        out = out.reshape(B, len(self.labels), -1) if var.class_per_label else out.reshape(B, -1)
        if var.class_sigmoid:
            out = torch.sigmoid(out)
        return masks.permute(0, 2, 3, 4, 1), out


def make_resunet(name: str, cfg: Optional[I3DConfig] = None, **kw) -> ResUNet3D:
    """One of the 7 reference variants by name (:data:`RESUNET_VARIANTS`)."""
    return ResUNet3D(cfg=cfg or I3DConfig(), variant=RESUNET_VARIANTS[name], **kw)


def freeze_mask_by_prefix(params: Dict[str, torch.Tensor], freeze_prefixes: Sequence[str]
                          ) -> Dict[str, bool]:
    """True = trainable, False = frozen, for each parameter name: frozen
    when its top-level module is one of ``freeze_prefixes`` (the reference's
    requires_grad surgery, unet_helper.py:91 freeze_net)."""
    prefixes = set(freeze_prefixes)
    return {k: k.split(".")[0] not in prefixes for k in params}


def unfreeze_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """All trainable (reference unfreeze_net, unet_helper.py:108)."""
    return {k: True for k in params}
