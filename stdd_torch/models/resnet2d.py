"""Legacy 2D ResNet classifier bases.

Port of ``stdd_tpu/models/resnet2d.py`` (reference
``model/classifier/_resnet_base.py``: a torchvision-style 2D ResNet,
BasicBlock :42 / Bottleneck :83 / ResNet :126 with the ``freeze_backbone``
detach :203-:220, and the variants resnet18/34/50/101/152,
resnext50_32x4d/101_32x8d, wide_resnet50_2/101_2 at :240-:350).

``forward(x)`` takes ``[B, H, W, 3]`` as the JAX module does; inside, NCHW
in the model's ``dtype`` over float32 parameters, flax's BatchNorm in train
mode, the pooled feature and ``fc`` in float32. Module names follow the
flax tree (``layer1_0.conv1.Conv_0``, ``….BatchNorm_0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .i3d import batch_norm, cast_conv, flax_reset_

VARIANTS = {
    # name: (block, layers, groups, width_per_group)
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 1, 64),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), 1, 128),
}


class ConvBN2d(nn.Module):
    """conv (no bias) → BN, optionally with a zero-init BN scale."""

    def __init__(self, dim_in: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, zero_init_scale: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(dim_in, features, kernel, stride, kernel // 2, groups=groups,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.zero_init_scale = zero_init_scale

    def forward(self, x, train: bool = False):
        return batch_norm(self.BatchNorm_0, cast_conv(self.Conv_0, x), train)


class BasicBlock2d(nn.Module):
    """3×3 + 3×3 residual block (reference _resnet_base.py:42)."""

    def __init__(self, dim_in: int, features: int, stride: int = 1,
                 zero_init_residual: bool = False):
        super().__init__()
        self.conv1 = ConvBN2d(dim_in, features, 3, stride)
        self.conv2 = ConvBN2d(features, features, 3, zero_init_scale=zero_init_residual)
        self.downsample = (ConvBN2d(dim_in, features, 1, stride)
                           if stride != 1 or dim_in != features else None)

    def forward(self, x, train: bool = False):
        h = self.conv2(F.relu(self.conv1(x, train)), train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return F.relu(x + h)


class Bottleneck2d(nn.Module):
    """1×1 / 3×3 (grouped) / 1×1 bottleneck (reference _resnet_base.py:83);
    width = planes·(width_per_group/64)·groups, as torchvision's."""

    def __init__(self, dim_in: int, planes: int, stride: int = 1, groups: int = 1,
                 width_per_group: int = 64, zero_init_residual: bool = False):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        out = planes * 4
        self.conv1 = ConvBN2d(dim_in, width, 1)
        self.conv2 = ConvBN2d(width, width, 3, stride, groups=groups)
        self.conv3 = ConvBN2d(width, out, 1, zero_init_scale=zero_init_residual)
        self.downsample = (ConvBN2d(dim_in, out, 1, stride)
                           if stride != 1 or dim_in != out else None)

    def forward(self, x, train: bool = False):
        h = F.relu(self.conv1(x, train))
        h = F.relu(self.conv2(h, train))
        h = self.conv3(h, train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return F.relu(x + h)


class ResNet2D(nn.Module):
    """Frame-level 2D ResNet classifier (reference ResNet,
    _resnet_base.py:126). ``forward(x)``: [B, H, W, 3] → logits
    [B, num_classes] float32; ``freeze_backbone=True`` stops gradients at
    the pooled feature (reference forward :218)."""

    def __init__(self, variant: str = "resnet18", num_classes: int = 2,
                 zero_init_residual: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        block, layers, groups, wpg = VARIANTS[variant]
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.block_names = []
        dim = 64
        for li, (n_blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                name = f"layer{li + 1}_{bi}"
                if block == "basic":
                    m = BasicBlock2d(dim, planes, stride, zero_init_residual)
                    dim = planes
                else:
                    m = Bottleneck2d(dim, planes, stride, groups, wpg, zero_init_residual)
                    dim = planes * 4
                self.add_module(name, m)
                self.block_names.append(name)
        self.fc = nn.Linear(dim, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults, with the zero-init residual scales."""
        flax_reset_(self, generator)
        for m in self.modules():
            if isinstance(m, ConvBN2d) and m.zero_init_scale:
                m.BatchNorm_0.weight.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                freeze_backbone: bool = False) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(batch_norm(self.bn1, cast_conv(self.conv1, x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(2, 3))
        if freeze_backbone:
            x = x.detach()
        return self.fc(x)
