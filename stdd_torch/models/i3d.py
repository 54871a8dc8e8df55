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
  statistics as a per-channel affine. On the card in bf16 or fp16 with no
  gradient recorded, ``Conv3dBN`` folds that affine's scale into the
  convolution's weight and adds its shift, with the block's residual and
  ReLU, in one pass of K3 (``ops/bias_act.py``), counted in
  ``Conv3dBN.folded_convs``; the CPU, float32, int8 stages and training
  keep the separate operations. Train (``train=True``): flax's
  ``nn.BatchNorm`` with ``use_running_average=False``
  (``stdd_tpu/models/i3d.py:168-175``) — each BN normalizes with the batch
  mean and the biased variance, reduced in float32 whatever the activation
  dtype, and moves its running statistics to ``(1-m)·old + m·batch`` with
  that same biased variance (``m = bn_momentum`` = 0.1, flax's decay 0.9);
  the head applies ``Dropout(dropout_rate)`` drawn from a caller-given
  ``torch.Generator``. The gradient reaches the float32 weights through the
  per-convolution cast to the compute dtype, as in flax.
- The convolutions are cuDNN's through ``F.conv3d`` (two of them re-laid in
  16 bits on the card, below) — the JAX model leaves them to XLA outside any
  Pallas kernel.
- ``s2d_stem``/``stem_t2`` are exact TPU re-layouts of the stem
  convolution (``stdd_tpu/models/i3d.py:61-78,244-307``); the port ignores
  the flags and matches the JAX model with them on. On the card in bf16 or
  fp16 it computes every stride-2 convolution over a channel count that is
  not a multiple of 8 (the stems) as the space-to-depth re-layout
  (:func:`space_to_depth_conv3d`, counted in ``Conv3dBN.s2d_convs``), and
  every ``[kt, 1, 1]`` convolution as a 2D one over (T, H·W)
  (:func:`temporal_conv3d_as_2d`, ``Conv3dBN.temporal_2d_convs``); on the
  CPU and in float32, the plain convolution.
- ``fused_s2`` runs each stride-1 block of s2 as one K2 launch
  (``ops/bottleneck.py``) over BN-folded weights, as the JAX model's
  ``ResBlock._fused`` does; the parameters stay where the unfused block
  keeps them, so one checkpoint serves both. Eval only: in train mode the
  blocks run unfused, as in JAX.
- ``int8_stages`` (eval only) runs every convolution of the named stages,
  projections included, as JAX's ``Conv3dBN._int8_conv``
  (``stdd_tpu/models/i3d.py:103-126``) computes it: per-output-channel
  int8 weights, per-tensor int8 activations (the scale taken over the whole
  batch, padding slots included, so a clip's score depends on its
  batch-mates, as in JAX), an int32 product through ``torch._int_mm`` over
  an im2col of the quantized input (cuBLASLt on the card), dequantized to
  float32; the BN after it returns to the compute dtype. Train mode ignores
  it; the parameter tree is the float path's.
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
from ..ops.bias_act import bias_act
from ..ops.bottleneck import fold_bn, fused_bottleneck
from ..parallel.mesh import active_data_parallel, global_rand, sync_batch_stats

# Stage depths for ResNet-{18,50,101} (video_model_builder.py:18)
STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# ImageNet normalization on the 0..255 scale (demo.py:84-87, TEST2.py:147-149)
IMAGENET_MEAN = np.array([0.485 * 255, 0.456 * 255, 0.406 * 255], dtype=np.float32)
IMAGENET_STD = np.array([0.229 * 255, 0.224 * 255, 0.225 * 255], dtype=np.float32)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a [Cout, Cin, kt, kh, kw]
    float32 kernel: ``sw = max(max|w|, 1e-8)/127``, ``wq = round(w/sw)``
    (half to even), as ``stdd_tpu/models/i3d.py:116-117``."""
    sw = torch.clamp(w.abs().amax(dim=(1, 2, 3, 4)), min=1e-8) / 127.0
    return torch.round(w / sw.view(-1, 1, 1, 1, 1)).to(torch.int8), sw


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``sx = max(max|x| in float32, 1e-8)/127``,
    ``xq = clip(round(x/sx), -127, 127)`` (``stdd_tpu/models/i3d.py:118-120``)."""
    sx = torch.clamp(x.abs().max().float(), min=1e-8) / 127.0
    return torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8), sx


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """The int32 accumulators of a 3D convolution of int8 ``xq`` [B, C, T,
    H, W] by int8 ``wq`` [Cout, C, kt, kh, kw] → [B, Cout, T', H', W']
    (``channels_last_3d``): an im2col of ``xq`` (a view for a 1×1×1
    stride-1 kernel) times the kernel in ``torch._int_mm``. cuBLASLt's int8
    GEMM takes more than 16 rows and K, N multiples of 8, so M, K and N are
    zero-padded to fit (exact). The sums stay below 2³¹: at most
    127²·27·2048 ≈ 8.9e8."""
    B = xq.shape[0]
    cout, _, kt, kh, kw = wq.shape
    st, sh, sw = stride
    if any(padding):
        pt, ph, pw = padding
        xq = F.pad(xq, (pw, pw, ph, ph, pt, pt))
    cols = xq.permute(0, 2, 3, 4, 1)                         # B T H W C
    if (kt, kh, kw) != (1, 1, 1) or (st, sh, sw) != (1, 1, 1):
        cols = cols.unfold(1, kt, st).unfold(2, kh, sh).unfold(3, kw, sw)   # B T' H' W' C kt kh kw
        cols = cols.permute(0, 1, 2, 3, 5, 6, 7, 4)                          # … kt kh kw C
    out_shape = cols.shape[:4]
    a = cols.reshape(-1, kt * kh * kw * xq.shape[1])
    w = wq.permute(0, 2, 3, 4, 1).reshape(cout, -1)          # [N, K], K in (kt, kh, kw, C)
    M, K = a.shape
    Mp, Kp, Np = max(M, 17), _round_up(K, 8), _round_up(cout, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (cout, K):
        w = F.pad(w, (0, Kp - K, 0, Np - cout))
    acc = torch._int_mm(a.contiguous(), w.contiguous().t())
    int8_conv_acc.launches += 1
    acc = acc[:M, :cout].reshape(out_shape + (cout,))
    return acc.permute(0, 4, 1, 2, 3)


int8_conv_acc.launches = 0


def int8_conv_acc_reference(xq: torch.Tensor, wq: torch.Tensor, stride, padding
                            ) -> torch.Tensor:
    """Plain version of :func:`int8_conv_acc`: a float64 convolution of the
    integers, exact (each product ≤ 127², every sum far below 2⁵³)."""
    acc = F.conv3d(xq.double(), wq.double(), None, stride, padding)
    return acc.to(torch.int32)


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """JAX's ``Conv3dBN._int8_conv``: quantize ``x`` and ``w``, the int32
    product, ``acc.float() * (sx·sw)`` → float32."""
    wq, sw = quantize_weight(w.float())
    xq, sx = quantize_activation(x)
    acc = int8_conv_acc(xq, wq, stride, padding)
    return acc.float() * (sx * sw).view(1, -1, 1, 1, 1)


def _s2d_axis(n: int, k: int, p: int) -> Tuple[int, int, int, int]:
    """One spatial axis (even length ``n``, kernel ``k``, padding ``p``) of a
    stride-2 convolution over 2-pixel blocks: the zero taps put in front of
    the kernel so that the padding before the data is whole blocks, the
    kernel's length in blocks, the blocks of zeros before the data and the
    input's length in blocks (the data always fits: ``lead + n/2 <= nb``)."""
    front = p % 2
    kb = (k + front + 1) // 2
    return front, kb, (p + front) // 2, (n + 2 * p - k) // 2 + kb


def fits_space_to_depth(shape, stride) -> bool:
    """Whether :func:`space_to_depth_conv3d` computes a convolution of an
    input of ``shape`` [B, C, T, H, W]: a spatial stride of 2 over an even
    H and W."""
    return tuple(stride[1:]) == (2, 2) and shape[3] % 2 == 0 and shape[4] % 2 == 0


def space_to_depth_conv3d(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """``F.conv3d(x, w, None, stride, padding)`` for a spatial stride of 2
    (:func:`fits_space_to_depth`), as a stride-1 convolution over 2×2 pixel
    blocks folded into channels, the re-layout of JAX's ``s2d_stem``
    (``stdd_tpu/models/i3d.py:60-78``): a [t,7,7] kernel over C channels
    becomes [t,4,4] over 4C, its 7s zero-padded to 8 in front. The 4C
    channels are zero-padded to a multiple of 8, which cuDNN's bf16
    tensor-core engines need; the spatial padding is zero blocks in the
    input. Exact: every added tap meets a zero. ``x`` [B, C, T, H, W] and
    ``w`` [Cout, C, kt, kh, kw] in one dtype → ``channels_last_3d``; costs
    one zero fill and one copy of ``x`` (and of ``w``), differentiable in
    both."""
    (fh, kbh, ah, nh), (fw, kbw, aw, nw) = (
        _s2d_axis(n, k, p) for n, k, p in zip(x.shape[3:], w.shape[3:], padding[1:]))
    B, C, T, H, W = x.shape
    cout, _, kt, kh, kw = w.shape
    cs = _round_up(4 * C, 8)
    xs = x.new_zeros(B, T, nh, nw, cs)
    # block channels in (row parity, column parity, C) order, as JAX's _s2d_input
    dst = xs[..., :4 * C].unflatten(-1, (2, 2, C)).permute(0, 1, 2, 4, 3, 5, 6)
    dst[:, :, ah:ah + H // 2, :, aw:aw + W // 2].copy_(
        x.movedim(1, -1).unflatten(2, (H // 2, 2)).unflatten(4, (W // 2, 2)))
    wp = F.pad(w, (fw, 2 * kbw - kw - fw, fh, 2 * kbh - kh - fh))
    ws = w.new_zeros(cout, kt, kbh, kbw, cs)
    ws[..., :4 * C].unflatten(-1, (2, 2, C)).copy_(
        wp.unflatten(3, (kbh, 2)).unflatten(5, (kbw, 2)).permute(0, 2, 3, 5, 4, 6, 1))
    return F.conv3d(xs.movedim(-1, 1), ws.movedim(-1, 1), None, (stride[0], 1, 1),
                    (padding[0], 0, 0))


def fits_temporal_2d(kernel, stride, padding) -> bool:
    """Whether :func:`temporal_conv3d_as_2d` computes a convolution: a
    kernel over time alone (``[kt, 1, 1]``, kt > 1), spatial stride 1."""
    return (kernel[0] > 1 and tuple(kernel[1:]) == (1, 1) and tuple(stride[1:]) == (1, 1)
            and tuple(padding[1:]) == (0, 0))


def temporal_conv3d_as_2d(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """``F.conv3d(x, w, None, stride, padding)`` for a ``[kt, 1, 1]`` kernel
    (:func:`fits_temporal_2d`) as a 2D convolution over (T, H·W) by a
    ``[kt, 1]`` kernel: the same products and sums, laid out as views of a
    ``channels_last_3d`` ``x`` (NHWC in 2D), in and out."""
    B, C, T, H, W = x.shape
    x2 = x.movedim(1, -1).reshape(B, T, H * W, C).permute(0, 3, 1, 2)
    y = F.conv2d(x2, w.squeeze(-1), None, (stride[0], 1), (padding[0], 0))
    return y.permute(0, 2, 3, 1).unflatten(2, (H, W)).movedim(-1, 1)


class Conv3dBN(nn.Module):
    """conv3d (no bias) → BatchNorm, optionally with a zero-init BN scale
    (the final BN of a bottleneck). ``bn.momentum`` is torch's convention:
    the weight of the batch in the running statistics. ``int8``: in eval,
    the convolution is :func:`int8_conv` and the BN's output is cast back
    to the input's dtype, as flax's BN with ``dtype`` does.

    Where :meth:`folds` holds (eval on the card in 16 bits, no gradient
    recorded, not int8), BN's scale is folded into the convolution's weight
    and its shift is left to one K3 pass (``ops/bias_act.py``) that also
    adds a residual and applies the ReLU: :meth:`conv_bn` hands back the
    convolution's output and the shift still to add, :func:`finish_bn` adds
    it. Elsewhere the two compute conv → BN (→ + residual → ReLU) as
    before."""

    def __init__(self, dim_in: int, features: int, kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 padding: Optional[Sequence[int]] = None,
                 zero_init_scale: bool = False, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, int8: bool = False):
        super().__init__()
        pad = tuple(padding) if padding is not None else tuple(k // 2 for k in kernel)
        self.conv = nn.Conv3d(dim_in, features, kernel, stride, pad, bias=False)
        self.bn = nn.BatchNorm3d(features, eps=bn_eps, momentum=bn_momentum)
        self.zero_init_scale = zero_init_scale
        self.int8 = int8
        self._fold_key = None
        self._fold = None

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

    # convolutions run by space_to_depth_conv3d / temporal_conv3d_as_2d, and
    # those run with BN folded into their weight, over the process's life
    s2d_convs = 0
    temporal_2d_convs = 0
    folded_convs = 0

    def folds(self, x: torch.Tensor, train: bool) -> bool:
        """Whether this forward folds BN into the convolution: eval, on the
        card in bf16 or fp16, no gradient recorded, not int8."""
        return (not train and not self.int8 and x.is_cuda
                and x.dtype in (torch.bfloat16, torch.float16) and not torch.is_grad_enabled())

    def folded(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight · γ/√(σ²+ε) in ``dtype`` and ``channels_last_3d``, the shift
        β − μ·γ/√(σ²+ε)), both computed by ``ops/bottleneck.py::fold_bn``
        in float32 (float64 for a float64 module) and the shift kept so.
        Computed once per weight load, not in every forward: the key is
        every source tensor's address and version counter, which any
        in-place write (``load_state_dict`` included) bumps. A module made
        under ``torch.inference_mode`` holds inference tensors, which keep
        no version counter: it folds afresh in every forward."""
        bn = self.bn
        srcs = (self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        key = None
        if not any(t.is_inference() for t in srcs):
            key = (dtype, srcs[0].device) + tuple((t.data_ptr(), t._version) for t in srcs)
        if key is None or key != self._fold_key:
            with torch.no_grad():
                wf, shift = fold_bn(srcs[0].movedim(0, -1), *srcs[1:], bn.eps)
                wf = wf.movedim(-1, 0).to(dtype=dtype, memory_format=torch.channels_last_3d)
            self._fold, self._fold_key = (wf, shift), key
        return self._fold

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        c = self.conv
        # In 16 bits on the card, two shapes send cuDNN's heuristics to a
        # float32 NCDHW fallback (``indexed_f32f32``) instead of a tensor-core
        # engine: a channel count that is not a multiple of 8 (the stems' 3)
        # and, for some widths, a [kt, 1, 1] kernel. Both re-layouts are exact.
        half = x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
        if half and x.shape[1] % 8 and fits_space_to_depth(x.shape, c.stride):
            Conv3dBN.s2d_convs += 1
            return space_to_depth_conv3d(x, w, c.stride, c.padding)
        if half and fits_temporal_2d(c.kernel_size, c.stride, c.padding):
            Conv3dBN.temporal_2d_convs += 1
            return temporal_conv3d_as_2d(x, w, c.stride, c.padding)
        return F.conv3d(x, w, None, c.stride, c.padding)

    def conv_bn(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(y, shift): where :meth:`folds`, y is the convolution by the folded
        weight and ``shift`` BN's shift still to add (float32 [C]); else y
        is BN's output and ``shift`` None. :func:`finish_bn` completes
        either."""
        c = self.conv
        if self.int8 and not train:
            y = int8_conv(x, c.weight, c.stride, c.padding)
            return batch_norm(self.bn, y, False).to(x.dtype), None
        if self.folds(x, train):
            Conv3dBN.folded_convs += 1
            w, shift = self.folded(x.dtype)
            return self._conv(x, w), shift
        w = c.weight.to(dtype=x.dtype, memory_format=torch.channels_last_3d)
        return batch_norm(self.bn, self._conv(x, w), train), None

    def forward(self, x: torch.Tensor, train: bool = False, relu: bool = False) -> torch.Tensor:
        """conv → BN (→ ReLU)."""
        return finish_bn(*self.conv_bn(x, train), relu=relu)


def finish_bn(y: torch.Tensor, shift: Optional[torch.Tensor], relu: bool = False,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What follows :meth:`Conv3dBN.conv_bn` (and any max pool after it: the
    max commutes with a per-channel constant): with a ``shift`` (BN folded),
    one K3 pass ``act(y + shift (+ residual))`` in place over ``y``;
    without, ``residual + y`` and the ReLU as separate operations."""
    if shift is None:
        y = y if residual is None else residual + y
        return F.relu(y) if relu else y
    return bias_act(y, shift, residual, relu)


def join_residual(y: torch.Tensor, shift: Optional[torch.Tensor], x: torch.Tensor,
                  shortcut: Optional[nn.Module], train: bool) -> torch.Tensor:
    """``relu(shortcut(x) + BN(y))`` of a residual block from its last
    convolution's :meth:`Conv3dBN.conv_bn` (``y``, ``shift``) and the
    shortcut (the identity where None; else a module with ``conv_bn``). A
    projection folds as the last convolution does (the same input dtype and
    device, mode and ``int8``), so its shift joins ``shift`` and its output
    needs no pass of its own."""
    sc = x
    if shortcut is not None:
        sc, sc_shift = shortcut.conv_bn(x, train)
        if sc_shift is not None:
            shift = shift + sc_shift
    return finish_bn(y, shift, relu=True, residual=sc)


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
    (``nn.BatchNorm3d``'s own update would store the unbiased one).

    Inside a data-parallel block over more than one rank
    (``parallel/mesh.py::data_parallel``) the statistics are the global
    batch's, as GSPMD's mean over a sharded batch axis is in JAX: the mean
    and biased variance come from :func:`~stdd_torch.parallel.mesh.sync_batch_stats`
    (float32, or float64 for float64 ``x``), the gradient flows through
    their all-reduces, and every rank moves its running statistics by the
    same global values."""
    if not train:
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * inv
        view = (-1,) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(view) + shift.to(x.dtype).view(view)
    dp = active_data_parallel()
    if dp is not None:
        mean, var = sync_batch_stats(x, dp, torch.promote_types(x.dtype, torch.float32))
        view = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + bn.eps) * bn.weight
        y = (x - mean.view(view)) * scale.view(view) + bn.bias.view(view)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1 - m) * bn.running_var + m * var)
        return y.to(x.dtype)
    y, mean, invstd = torch.native_batch_norm(x, bn.weight, bn.bias, None, None, True,
                                              0.0, bn.eps)
    with torch.no_grad():
        var = (invstd.double().pow(-2) - bn.eps).clamp_(min=0).to(bn.running_var.dtype)
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
        x = self.pathway0_stem(x, train, relu=True)
        return max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class Bottleneck(nn.Module):
    """Tx1x1 → 1x3x3 (spatial stride here) → 1x1x1, BN after each
    (reference resnet_helper.py:196 BottleneckTransform). ``spatial_1x1``
    makes the middle convolution 1x1x1, stride kept: the FTCN
    "temporal-only" variant (reference
    i3d_temporal_var_fix_dropout_tt_cfg.py:207)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, zero_init_final_bn: bool,
                 bn_eps: float, bn_momentum: float = 0.1, spatial_1x1: bool = False,
                 int8: bool = False):
        super().__init__()
        tk = temp_kernel_size
        ks = 1 if spatial_1x1 else 3
        bn = dict(bn_eps=bn_eps, bn_momentum=bn_momentum, int8=int8)
        self.a = Conv3dBN(dim_in, dim_inner, (tk, 1, 1), (1, 1, 1), (tk // 2, 0, 0), **bn)
        self.b = Conv3dBN(dim_inner, dim_inner, (1, ks, ks), (1, stride, stride),
                          (0, ks // 2, ks // 2), **bn)
        self.c = Conv3dBN(dim_inner, dim_out, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                          zero_init_scale=zero_init_final_bn, **bn)

    def forward(self, x, train: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(c's output, its BN shift still to add or None), as
        :meth:`Conv3dBN.conv_bn`."""
        x = self.a(x, train, relu=True)
        x = self.b(x, train, relu=True)
        return self.c.conv_bn(x, train)


class ResBlock(nn.Module):
    """Residual block with a projection shortcut when dims or stride change
    (reference resnet_helper.py:329). With ``fused_eval`` and stride 1 the
    whole block is one K2 launch (``stdd_tpu/models/i3d.py:439-443,475``);
    a ``spatial_1x1`` block never is (K2 computes a 3×3 middle)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel_size: int, stride: int, zero_init_final_bn: bool,
                 bn_eps: float, fused_eval: bool = False, bn_momentum: float = 0.1,
                 spatial_1x1: bool = False, int8: bool = False):
        super().__init__()
        self.branch2 = Bottleneck(dim_in, dim_out, dim_inner, temp_kernel_size,
                                  stride, zero_init_final_bn, bn_eps, bn_momentum,
                                  spatial_1x1, int8)
        self.shortcut = (
            Conv3dBN(dim_in, dim_out, (1, 1, 1), (1, stride, stride), (0, 0, 0),
                     bn_eps=bn_eps, bn_momentum=bn_momentum, int8=int8)
            if dim_in != dim_out or stride != 1 else None
        )
        self.tk = temp_kernel_size
        self.fused_eval = fused_eval and stride == 1 and not spatial_1x1
        self._fold_key = None
        self._fold = None

    def folded_weights(self, dtype: torch.dtype):
        """K2's operands (wa, ba, wb, bb, wc, bc, ws, bs): each convolution's
        :meth:`Conv3dBN.folded` weight re-laid in the JAX layout, and its
        shift. The layout copies are made again only when a fold is."""
        br = self.branch2
        # each convolution and the leading (kernel) axes of its K2 layout
        convs = [(br.a, (self.tk,)), (br.b, (3, 3)), (br.c, ())]
        if self.shortcut is not None:
            convs.append((self.shortcut, ()))
        folds = [m.folded(dtype) for m, _ in convs]
        if self._fold_key is None or any(a is not b for a, b in zip(self._fold_key, folds)):
            out = []
            for (wf, shift), (_, lead) in zip(folds, convs):       # wf [Cout, Cin, kt, kh, kw]
                wf = wf.permute(2, 3, 4, 1, 0).reshape(lead + (wf.shape[1], wf.shape[0]))
                out += [wf.contiguous(), shift]
            if self.shortcut is None:
                out += [None, None]
            self._fold, self._fold_key = tuple(out), folds
        return self._fold

    def forward(self, x, bottleneck=fused_bottleneck, train: bool = False):
        """``bottleneck``: the K2 entry point a fused block calls in eval
        (its plain version can stand in to hold the kernel to it)."""
        if self.fused_eval and not train:
            return bottleneck(x, *self.folded_weights(x.dtype), tk=self.tk)
        br, shift = self.branch2(x, train)          # branch first, as JAX runs it
        return join_residual(br, shift, x, self.shortcut, train)


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
                 bn_momentum: float = 0.1, spatial_1x1: bool = False, int8: bool = False):
        super().__init__()
        tks = stage_temp_kernels(temp_kernel_basis, num_blocks, num_block_temp_kernel)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"pathway0_res{i}", ResBlock(
                dim_in if i == 0 else dim_out, dim_out, dim_inner, tks[i],
                stride if i == 0 else 1, zero_init_final_bn, bn_eps, fused_eval, bn_momentum,
                spatial_1x1, int8))

    def forward(self, x, bottleneck=fused_bottleneck, train: bool = False):
        for i in range(self.num_blocks):
            x = getattr(self, f"pathway0_res{i}")(x, bottleneck, train)
        return x


def flax_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training: each element is kept with
    probability ``1 - rate`` (the mask drawn from ``generator``, on ``x``'s
    device; in a data-parallel block, this rank's rows of the global
    batch's mask) and the kept ones are scaled by ``1/(1 - rate)``."""
    if rate <= 0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    mask = global_rand(x.shape, generator, x.device) < keep
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
                                           spatial_1x1=c.temporal_only,
                                           int8=name in c.int8_stages))
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
