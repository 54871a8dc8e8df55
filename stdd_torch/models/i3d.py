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
- Eval (``train=False``, the default): BatchNorm applies its running
  statistics as a per-channel affine. Train (``train=True``): flax's
  ``nn.BatchNorm`` with ``use_running_average=False``
  (``stdd_tpu/models/i3d.py:168-175``) — each BN normalizes with the batch
  mean and the biased variance, reduced in float32 whatever the activation
  dtype, and moves its running statistics to ``(1-m)·old + m·batch`` with
  that same biased variance (``m = bn_momentum`` = 0.1, flax's decay 0.9);
  the head applies ``Dropout(dropout_rate)`` drawn from a caller-given
  ``torch.Generator``. The gradient reaches the float32 weights through the
  per-convolution cast to the compute dtype, as in flax.
- The convolutions are plain ``F.conv3d`` (cuDNN on the card) — the JAX
  model leaves them to XLA outside any Pallas kernel.
- ``s2d_stem``/``stem_t2`` are exact TPU re-layouts of the stem
  convolution (``stdd_tpu/models/i3d.py:61-78,244-307``); the port computes
  the plain convolution and matches the JAX model with those flags on.
- ``fused_s2`` runs each stride-1 block of s2 as one K2 launch
  (``ops/bottleneck.py``) over BN-folded weights, as the JAX model's
  ``ResBlock._fused`` does; the parameters stay where the unfused block
  keeps them, so one checkpoint serves both. Eval only: in train mode the
  blocks run unfused, as in JAX.
- ``temporal_only`` is the FTCN trunk inside the I3D: every bottleneck's
  middle convolution becomes 1×1×1 (``spatial_1x1``,
  ``stdd_tpu/models/i3d.py:357-389``) and the stages stop before
  ``s{stop_point}`` (``:632-634``). JAX leaves such blocks unfused
  (``:440-441``), so ``fused_s2`` launches K2 on none of them.

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
from ..ops.bottleneck import fold_bn, fused_bottleneck

# Stage depths for ResNet-{18,50,101} (video_model_builder.py:18)
STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# ImageNet normalization on the 0..255 scale (demo.py:84-87, TEST2.py:147-149)
IMAGENET_MEAN = np.array([0.485 * 255, 0.456 * 255, 0.406 * 255], dtype=np.float32)
IMAGENET_STD = np.array([0.229 * 255, 0.224 * 255, 0.225 * 255], dtype=np.float32)


class Conv3dBN(nn.Module):
    """conv3d (no bias) → BatchNorm, optionally with a zero-init BN scale
    (the final BN of a bottleneck). ``bn.momentum`` is torch's convention:
    the weight of the batch in the running statistics."""

    def __init__(self, dim_in: int, features: int, kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 padding: Optional[Sequence[int]] = None,
                 zero_init_scale: bool = False, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        super().__init__()
        pad = tuple(padding) if padding is not None else tuple(k // 2 for k in kernel)
        self.conv = nn.Conv3d(dim_in, features, kernel, stride, pad, bias=False)
        self.bn = nn.BatchNorm3d(features, eps=bn_eps, momentum=bn_momentum)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w = self.conv.weight.to(dtype=x.dtype, memory_format=torch.channels_last_3d)
        x = F.conv3d(x, w, None, self.conv.stride, self.conv.padding)
        return batch_norm(self.bn, x, train)


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, train: bool
               ) -> torch.Tensor:
    """flax's ``nn.BatchNorm`` over the channels of an NC… tensor ``x``.

    Eval: the running statistics as a per-channel affine in ``x``'s dtype.
    Train: batch statistics (float32 reductions, biased variance) normalize
    ``x`` through one fused op, PyTorch's native batch-norm, which takes
    bf16 activations with float32 parameters and differentiates in closed
    form; then the running statistics move to ``(1-m)·old + m·batch`` with
    ``m = bn.momentum``. The op hands back the mean and
    ``1/sqrt(var + eps)``, from which the biased variance is recovered
    (``nn.BatchNorm3d``'s own update would store the unbiased one)."""
    if not train:
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * inv
        view = (-1,) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(view) + shift.to(x.dtype).view(view)
    y, mean, invstd = torch.native_batch_norm(x, bn.weight, bn.bias, None, None, True,
                                              0.0, bn.eps)
    with torch.no_grad():
        var = (invstd.double().pow(-2) - bn.eps).clamp_(min=0).float()
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var)
    return y


def max_pool_3d(x: torch.Tensor, window, strides, padding) -> torch.Tensor:
    """3D max pool over NCTHW; ``padding`` per dim (symmetric, -inf fill as
    flax's ``nn.max_pool``)."""
    return F.max_pool3d(x, window, strides, padding)


class VideoStem(nn.Module):
    """s1: conv [t,7,7] stride [1,2,2] → BN → ReLU → maxpool [1,3,3]/[1,2,2]
    (reference stem_helper.py:156-171)."""

    def __init__(self, dim_in: int, features: int, temp_kernel: int, bn_eps: float,
                 bn_momentum: float = 0.1):
        super().__init__()
        t = temp_kernel
        self.pathway0_stem = Conv3dBN(dim_in, features, (t, 7, 7), (1, 2, 2),
                                      (t // 2, 3, 3), bn_eps=bn_eps, bn_momentum=bn_momentum)

    def forward(self, x, train: bool = False):
        x = F.relu(self.pathway0_stem(x, train))
        return max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class Bottleneck(nn.Module):
    """Tx1x1 → 1x3x3 (spatial stride here) → 1x1x1, BN after each
    (reference resnet_helper.py:196 BottleneckTransform). ``spatial_1x1``
    makes the middle convolution 1x1x1, stride kept: the FTCN
    "temporal-only" variant (reference
    i3d_temporal_var_fix_dropout_tt_cfg.py:207)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, zero_init_final_bn: bool,
                 bn_eps: float, bn_momentum: float = 0.1, spatial_1x1: bool = False):
        super().__init__()
        tk = temp_kernel_size
        ks = 1 if spatial_1x1 else 3
        bn = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
        self.a = Conv3dBN(dim_in, dim_inner, (tk, 1, 1), (1, 1, 1), (tk // 2, 0, 0), **bn)
        self.b = Conv3dBN(dim_inner, dim_inner, (1, ks, ks), (1, stride, stride),
                          (0, ks // 2, ks // 2), **bn)
        self.c = Conv3dBN(dim_inner, dim_out, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                          zero_init_scale=zero_init_final_bn, **bn)

    def forward(self, x, train: bool = False):
        x = F.relu(self.a(x, train))
        x = F.relu(self.b(x, train))
        return self.c(x, train)


class ResBlock(nn.Module):
    """Residual block with a projection shortcut when dims or stride change
    (reference resnet_helper.py:329). With ``fused_eval`` and stride 1 the
    whole block is one K2 launch (``stdd_tpu/models/i3d.py:439-443,475``);
    a ``spatial_1x1`` block never is (K2 computes a 3×3 middle)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, zero_init_final_bn: bool,
                 bn_eps: float, fused_eval: bool = False, bn_momentum: float = 0.1,
                 spatial_1x1: bool = False):
        super().__init__()
        self.branch2 = Bottleneck(dim_in, dim_out, dim_inner, temp_kernel_size,
                                  stride, zero_init_final_bn, bn_eps, bn_momentum,
                                  spatial_1x1)
        self.shortcut = (
            Conv3dBN(dim_in, dim_out, (1, 1, 1), (1, stride, stride), (0, 0, 0),
                     bn_eps=bn_eps, bn_momentum=bn_momentum)
            if dim_in != dim_out or stride != 1 else None
        )
        self.tk = temp_kernel_size
        self.fused_eval = fused_eval and stride == 1 and not spatial_1x1
        self._fold_key = None
        self._fold = None

    def folded_weights(self, dtype: torch.dtype):
        """K2's operands (wa, ba, wb, bb, wc, bc, ws, bs): BN folded into
        each convolution in float32, kernels in the JAX layout cast to
        ``dtype``. Computed once per weight load, not in every forward: the
        key is every source tensor's address and version counter, which any
        in-place write (``load_state_dict`` included) bumps."""
        br = self.branch2
        # each convolution and the leading (kernel) axes of its K2 layout
        convs = [(br.a, (self.tk,)), (br.b, (3, 3)), (br.c, ())]
        if self.shortcut is not None:
            convs.append((self.shortcut, ()))
        srcs = [t for m, _ in convs for t in (m.conv.weight, m.bn.weight, m.bn.bias,
                                              m.bn.running_mean, m.bn.running_var)]
        key = (dtype, srcs[0].device) + tuple((t.data_ptr(), t._version) for t in srcs)
        if key != self._fold_key:
            out = []
            with torch.no_grad():
                for m, lead in convs:
                    w = m.conv.weight                      # [Cout, Cin, kt, kh, kw]
                    w = w.permute(2, 3, 4, 1, 0).reshape(lead + (w.shape[1], w.shape[0]))
                    bn = m.bn
                    wf, bf = fold_bn(w, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                     bn.eps)
                    out += [wf.to(dtype), bf]
            if self.shortcut is None:
                out += [None, None]
            self._fold, self._fold_key = tuple(out), key
        return self._fold

    def forward(self, x, bottleneck=fused_bottleneck, train: bool = False):
        """``bottleneck``: the K2 entry point a fused block calls in eval
        (its plain version can stand in to hold the kernel to it)."""
        if self.fused_eval and not train:
            return bottleneck(x, *self.folded_weights(x.dtype), tk=self.tk)
        sc = self.shortcut(x, train) if self.shortcut is not None else x
        return F.relu(sc + self.branch2(x, train))


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
                 zero_init_final_bn: bool, bn_eps: float, fused_eval: bool = False,
                 bn_momentum: float = 0.1, spatial_1x1: bool = False):
        super().__init__()
        tks = stage_temp_kernels(temp_kernel_basis, num_blocks, num_block_temp_kernel)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"pathway0_res{i}", ResBlock(
                dim_in if i == 0 else dim_out, dim_out, dim_inner, tks[i],
                stride if i == 0 else 1, zero_init_final_bn, bn_eps, fused_eval, bn_momentum,
                spatial_1x1))

    def forward(self, x, bottleneck=fused_bottleneck, train: bool = False):
        for i in range(self.num_blocks):
            x = getattr(self, f"pathway0_res{i}")(x, bottleneck, train)
        return x


def flax_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training: each element is kept with
    probability ``1 - rate`` (the mask drawn from ``generator``, on ``x``'s
    device) and the kept ones are scaled by ``1/(1 - rate)``."""
    if rate <= 0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def cast_conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` for a Conv1d/2d/3d module ``m`` in ``x``'s dtype over its
    float32 parameters, as flax's ``nn.Conv(dtype=...)`` computes."""
    b = m.bias.to(x.dtype) if m.bias is not None else None
    return m._conv_forward(x, m.weight.to(x.dtype), b)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel initializer, lecun_normal: a normal truncated
    at ±2 standard deviations, scaled to the variance 1/fan_in (a torch
    weight's fan-in is the product of its dims after the first). Drawn on
    the generator's host, then copied."""
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.copy_(w * (math.sqrt(1.0 / math.prod(w.shape[1:])) / 0.87962566103423978))


@torch.no_grad()
def flax_reset_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults over every submodule: Dense and Conv kernels
    :func:`lecun_normal_` with zero biases, norms ones and zeros."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            m.reset_parameters()


class I3DHead(nn.Module):
    """Dropout (train only) → linear → raw logits over the pooled features
    (reference head_helper.py:9; callers apply the sigmoid)."""

    def __init__(self, dim_in: int, num_classes: int, fc_init_std: float,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.projection = nn.Linear(dim_in, num_classes)
        self.fc_init_std = fc_init_std
        self.dropout_rate = dropout_rate

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        w = self.projection.weight
        w.copy_(torch.randn(w.shape, generator=generator) * self.fc_init_std)
        self.projection.bias.zero_()

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode, :func:`flax_dropout` of the features first."""
        if train:
            feats = flax_dropout(feats, self.dropout_rate, generator)
        return self.projection(feats)


class I3D(nn.Module):
    """The full I3D-ResNet: s1 → s2 → T-maxpool → s3 → s4 → s5 → head
    (with ``temporal_only``, the stages before ``s{stop_point}``, at least
    s2).

    ``forward(x)``: ``x`` [B, T, H, W, 3] float (already normalized) →
    ``[B, num_classes]`` float32 logits; with ``return_features=True`` also
    the pooled penultimate embedding ``[B, C]`` float32 (2048 for the full
    I3D-R50)."""

    def __init__(self, cfg: Optional[I3DConfig] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg or I3DConfig()
        if c.int8_stages:
            raise NotImplementedError(
                f"int8_stages={c.int8_stages}: the int8 path is not ported yet "
                "(ROADMAP §1 item 9)")
        self.cfg = c
        self.compute_dtype = dtype
        d2, d3, d4, d5 = STAGE_DEPTH[c.depth]
        w = c.width_per_group
        inner = c.num_groups * w
        self.s1 = VideoStem(c.input_channels, w, c.temp_kernel[0][0], c.bn_eps, c.bn_momentum)
        stages = [
            # (name, dim_in, dim_out, dim_inner, basis, blocks, n_temp, stride)
            ("s2", w, w * 4, inner, c.temp_kernel[1], d2, c.num_block_temp_kernel[0], c.spatial_strides[0]),
            ("s3", w * 4, w * 8, inner * 2, c.temp_kernel[2], d3, c.num_block_temp_kernel[1], c.spatial_strides[1]),
            ("s4", w * 8, w * 16, inner * 4, c.temp_kernel[3], d4, c.num_block_temp_kernel[2], c.spatial_strides[2]),
            ("s5", w * 16, w * 32, inner * 8, c.temp_kernel[4], d5, c.num_block_temp_kernel[3], c.spatial_strides[3]),
        ]
        # FTCN truncation: stop_point=k removes stages s_k..s5 (reference
        # i3d_temporal_var_fix_dropout_tt_cfg.py:315-330)
        n_stages = min(4, max(1, c.stop_point - 2)) if c.temporal_only else 4
        self.stage_names = [name for name, *_ in stages[:n_stages]]
        for name, di, do, dinner, basis, blocks, ntemp, stride in stages[:n_stages]:
            # fused_s2: the eval-only K2 blocks of s2 (stdd_tpu/models/i3d.py:647)
            self.add_module(name, ResStage(di, do, dinner, basis, blocks, ntemp,
                                           stride, c.zero_init_final_bn, c.bn_eps,
                                           fused_eval=name == "s2" and c.fused_s2,
                                           bn_momentum=c.bn_momentum,
                                           spatial_1x1=c.temporal_only))
        self.head = I3DHead(stages[n_stages - 1][2], c.num_classes, c.fc_init_std,
                            c.dropout_rate)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers (MSRA conv fill, BN ones/zeros with
        zero-init final BN, normal head), drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (Conv3dBN, I3DHead)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                bottleneck=fused_bottleneck, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``bottleneck``: what the ``fused_s2`` blocks call in eval, K2 by
        default (``ResBlock.forward``). ``train``: batch statistics in every
        BN (moving the running ones) and the head's dropout, whose mask
        ``generator`` draws."""
        c = self.cfg
        x = x.to(self.compute_dtype).permute(0, 4, 1, 2, 3)          # NTHWC → NCTHW view
        x = x.contiguous(memory_format=torch.channels_last_3d)
        x = self.s1(x, train)
        x = self.s2(x, bottleneck, train)
        if c.t_pool_after_s2 > 1:
            # pathway0_pool: MaxPool3d [2,1,1] (video_model_builder.py:477)
            tp = c.t_pool_after_s2
            x = max_pool_3d(x, (tp, 1, 1), (tp, 1, 1), (0, 0, 0))
        for name in self.stage_names[1:]:
            x = getattr(self, name)(x, train=train)
        feats = x.to(self.head.projection.weight.dtype).mean(dim=(2, 3, 4))
        logits = self.head(feats, train, generator)
        if return_features:
            return logits, feats
        return logits
