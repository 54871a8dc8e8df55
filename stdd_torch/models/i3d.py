"""I3D-ResNet50 eval forward — the production AltFreezing classifier.

Port of ``stdd_tpu/models/i3d.py`` (structure: reference
``slowfast/models/video_model_builder.py:391``; stem ``stem_helper.py:102``;
bottleneck ``resnet_helper.py:196``; head ``head_helper.py:9``).

- The public boundary takes ``[B, T, H, W, C]`` (NTHWC), as the JAX model
  does. Inside, activations are NCTHW tensors in ``channels_last_3d``
  memory order — the permute of a contiguous NTHWC tensor is exactly that
  layout, so entering and leaving costs no copy.
- Parameters and BN statistics are float32; the forward computes in the
  model's ``dtype`` (bf16 by default in the scorer, as the JAX scorer does)
  with the head in float32.
- Eval only: BatchNorm applies its running statistics as a per-channel
  affine. The convolutions are plain ``F.conv3d`` (cuDNN on the card) — the
  JAX model leaves them to XLA outside any Pallas kernel.
- ``s2d_stem``/``stem_t2`` are exact TPU re-layouts of the stem
  convolution (``stdd_tpu/models/i3d.py:61-78,244-307``); the port computes
  the plain convolution and matches the JAX model with those flags on.

Module names follow the flax parameter tree (``s1.pathway0_stem.conv`` …,
``head.projection``) so the weight bridge (``utils/weights.py``) is a pure
name map.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import I3DConfig

# Stage depths for ResNet-{18,50,101} (video_model_builder.py:18)
STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# ImageNet normalization on the 0..255 scale (demo.py:84-87, TEST2.py:147-149)
IMAGENET_MEAN = np.array([0.485 * 255, 0.456 * 255, 0.406 * 255], dtype=np.float32)
IMAGENET_STD = np.array([0.229 * 255, 0.224 * 255, 0.225 * 255], dtype=np.float32)


class Conv3dBN(nn.Module):
    """conv3d (no bias) → eval BatchNorm, optionally with a zero-init BN
    scale (the final BN of a bottleneck)."""

    def __init__(self, dim_in: int, features: int, kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 padding: Optional[Sequence[int]] = None,
                 zero_init_scale: bool = False, bn_eps: float = 1e-5):
        super().__init__()
        pad = tuple(padding) if padding is not None else tuple(k // 2 for k in kernel)
        self.conv = nn.Conv3d(dim_in, features, kernel, stride, pad, bias=False)
        self.bn = nn.BatchNorm3d(features, eps=bn_eps)
        self.zero_init_scale = zero_init_scale

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Caffe2 MSRA fill (fan_out over [kt,kh,kw,cout]; weight_init_helper.py:28)
        and BN ones/zeros, or a zero scale for the final BN of a block."""
        w = self.conv.weight
        cout, _, kt, kh, kw = w.shape
        std = math.sqrt(2.0 / (kt * kh * kw * cout))
        w.copy_(torch.randn(w.shape, generator=generator) * std)
        self.bn.reset_parameters()
        if self.zero_init_scale:
            self.bn.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(dtype=x.dtype, memory_format=torch.channels_last_3d)
        x = F.conv3d(x, w, None, self.conv.stride, self.conv.padding)
        bn = self.bn
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * inv
        return (x * inv.to(x.dtype).view(-1, 1, 1, 1)
                + shift.to(x.dtype).view(-1, 1, 1, 1))


def max_pool_3d(x: torch.Tensor, window, strides, padding) -> torch.Tensor:
    """3D max pool over NCTHW; ``padding`` per dim (symmetric, -inf fill as
    flax's ``nn.max_pool``)."""
    return F.max_pool3d(x, window, strides, padding)


class VideoStem(nn.Module):
    """s1: conv [t,7,7] stride [1,2,2] → BN → ReLU → maxpool [1,3,3]/[1,2,2]
    (reference stem_helper.py:156-171)."""

    def __init__(self, dim_in: int, features: int, temp_kernel: int, bn_eps: float):
        super().__init__()
        t = temp_kernel
        self.pathway0_stem = Conv3dBN(dim_in, features, (t, 7, 7), (1, 2, 2),
                                      (t // 2, 3, 3), bn_eps=bn_eps)

    def forward(self, x):
        x = F.relu(self.pathway0_stem(x))
        return max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class Bottleneck(nn.Module):
    """Tx1x1 → 1x3x3 (spatial stride here) → 1x1x1, BN after each
    (reference resnet_helper.py:196 BottleneckTransform)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, zero_init_final_bn: bool,
                 bn_eps: float):
        super().__init__()
        tk = temp_kernel_size
        self.a = Conv3dBN(dim_in, dim_inner, (tk, 1, 1), (1, 1, 1),
                          (tk // 2, 0, 0), bn_eps=bn_eps)
        self.b = Conv3dBN(dim_inner, dim_inner, (1, 3, 3), (1, stride, stride),
                          (0, 1, 1), bn_eps=bn_eps)
        self.c = Conv3dBN(dim_inner, dim_out, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                          zero_init_scale=zero_init_final_bn, bn_eps=bn_eps)

    def forward(self, x):
        x = F.relu(self.a(x))
        x = F.relu(self.b(x))
        return self.c(x)


class ResBlock(nn.Module):
    """Residual block with a projection shortcut when dims or stride change
    (reference resnet_helper.py:329)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, zero_init_final_bn: bool,
                 bn_eps: float):
        super().__init__()
        self.branch2 = Bottleneck(dim_in, dim_out, dim_inner, temp_kernel_size,
                                  stride, zero_init_final_bn, bn_eps)
        self.shortcut = (
            Conv3dBN(dim_in, dim_out, (1, 1, 1), (1, stride, stride), (0, 0, 0),
                     bn_eps=bn_eps)
            if dim_in != dim_out or stride != 1 else None
        )

    def forward(self, x):
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(sc + self.branch2(x))


def stage_temp_kernels(basis: Sequence[int], num_blocks: int, num_temp: int) -> Tuple[int, ...]:
    """Per-block temporal kernels: tile the basis, truncate to ``num_temp``
    blocks, pad the rest with 1 (reference resnet_helper.py:530-534)."""
    tiled = (tuple(basis) * num_blocks)[:num_temp]
    return tiled + (1,) * (num_blocks - num_temp)


class ResStage(nn.Module):
    """One stage of the 3D ResNet (reference resnet_helper.py:447)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_basis: Sequence[int], num_blocks: int,
                 num_block_temp_kernel: int, stride: int,
                 zero_init_final_bn: bool, bn_eps: float):
        super().__init__()
        tks = stage_temp_kernels(temp_kernel_basis, num_blocks, num_block_temp_kernel)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"pathway0_res{i}", ResBlock(
                dim_in if i == 0 else dim_out, dim_out, dim_inner, tks[i],
                stride if i == 0 else 1, zero_init_final_bn, bn_eps))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"pathway0_res{i}")(x)
        return x


class I3DHead(nn.Module):
    """Global average pool → (eval) dropout → linear → raw logits
    (reference head_helper.py:9; callers apply the sigmoid)."""

    def __init__(self, dim_in: int, num_classes: int, fc_init_std: float):
        super().__init__()
        self.projection = nn.Linear(dim_in, num_classes)
        self.fc_init_std = fc_init_std

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        w = self.projection.weight
        w.copy_(torch.randn(w.shape, generator=generator) * self.fc_init_std)
        self.projection.bias.zero_()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.projection(feats)


class I3D(nn.Module):
    """The full I3D-ResNet: s1 → s2 → T-maxpool → s3 → s4 → s5 → head.

    ``forward(x)``: ``x`` [B, T, H, W, 3] float (already normalized) →
    ``[B, num_classes]`` float32 logits; with ``return_features=True`` also
    the pooled penultimate embedding ``[B, 2048]`` float32."""

    def __init__(self, cfg: Optional[I3DConfig] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg or I3DConfig()
        if c.temporal_only or c.fused_s2 or c.int8_stages:
            raise NotImplementedError(
                "temporal_only, fused_s2 and int8_stages are not ported yet "
                f"(got temporal_only={c.temporal_only}, fused_s2={c.fused_s2}, "
                f"int8_stages={c.int8_stages})")
        self.cfg = c
        self.compute_dtype = dtype
        d2, d3, d4, d5 = STAGE_DEPTH[c.depth]
        w = c.width_per_group
        inner = c.num_groups * w
        self.s1 = VideoStem(c.input_channels, w, c.temp_kernel[0][0], c.bn_eps)
        stages = [
            # (name, dim_in, dim_out, dim_inner, basis, blocks, n_temp, stride)
            ("s2", w, w * 4, inner, c.temp_kernel[1], d2, c.num_block_temp_kernel[0], c.spatial_strides[0]),
            ("s3", w * 4, w * 8, inner * 2, c.temp_kernel[2], d3, c.num_block_temp_kernel[1], c.spatial_strides[1]),
            ("s4", w * 8, w * 16, inner * 4, c.temp_kernel[3], d4, c.num_block_temp_kernel[2], c.spatial_strides[2]),
            ("s5", w * 16, w * 32, inner * 8, c.temp_kernel[4], d5, c.num_block_temp_kernel[3], c.spatial_strides[3]),
        ]
        for name, di, do, dinner, basis, blocks, ntemp, stride in stages:
            self.add_module(name, ResStage(di, do, dinner, basis, blocks, ntemp,
                                           stride, c.zero_init_final_bn, c.bn_eps))
        self.head = I3DHead(w * 32, c.num_classes, c.fc_init_std)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers (MSRA conv fill, BN ones/zeros with
        zero-init final BN, normal head), drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (Conv3dBN, I3DHead)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        c = self.cfg
        x = x.to(self.compute_dtype).permute(0, 4, 1, 2, 3)          # NTHWC → NCTHW view
        x = x.contiguous(memory_format=torch.channels_last_3d)
        x = self.s1(x)
        x = self.s2(x)
        if c.t_pool_after_s2 > 1:
            # pathway0_pool: MaxPool3d [2,1,1] (video_model_builder.py:477)
            tp = c.t_pool_after_s2
            x = max_pool_3d(x, (tp, 1, 1), (tp, 1, 1), (0, 0, 0))
        x = self.s5(self.s4(self.s3(x)))
        feats = x.float().mean(dim=(2, 3, 4))
        logits = self.head(feats)
        if return_features:
            return logits, feats
        return logits
