"""SlowFast dual-pathway video network and the Non-local block.

Port of ``stdd_tpu/models/slowfast.py`` (reference
``slowfast/models/video_model_builder.py:147`` SlowFast, ``:86``
FuseFastToSlow; ``nonlocal_helper.py:10`` Nonlocal). Defaults follow the
reference config (defaults.py:241-252): ALPHA 8 (the fast pathway samples 8×
denser), BETA_INV 8 (the fast pathway is 1/8 wide), fusion ratio 2, fusion
kernel 5. Input: one clip ``[B, T, H, W, 3]``; the slow pathway takes every
ALPHA-th frame, the fast pathway all of them.

Built from the I3D's modules (``models/i3d.py``): NCTHW ``channels_last_3d``
activations in the model's ``dtype`` over float32 parameters, flax's
BatchNorm in train mode, the head in float32. Module names follow the flax
tree (``s1_slow``, ``s2_fast``, ``s1_fuse.conv_f2s``, ``projection``), for
``utils/weights.py::flax_to_torch``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import I3DConfig
from .i3d import (STAGE_DEPTH, Conv3dBN, ResStage, VideoStem, batch_norm, flax_dropout,
                  flax_reset_, max_pool_3d)

# temporal kernel basis for arch "slowfast" (video_model_builder.py:65-72)
SF_TEMP_KERNEL = {
    "slow": ((1,), (1,), (1,), (3,), (3,)),
    "fast": ((5,), (3,), (3,), (3,), (3,)),
}


class FuseFastToSlow(nn.Module):
    """Fast→slow lateral connection: a strided temporal conv on the fast
    pathway, concatenated onto the slow one (video_model_builder.py:86)."""

    def __init__(self, dim_in_fast: int, ratio: int = 2, kernel: int = 5, alpha: int = 8,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1):
        super().__init__()
        self.conv_f2s = Conv3dBN(dim_in_fast, dim_in_fast * ratio, (kernel, 1, 1), (alpha, 1, 1),
                                 (kernel // 2, 0, 0), bn_eps=bn_eps, bn_momentum=bn_momentum)

    def forward(self, slow, fast, train: bool = False):
        fuse = F.relu(self.conv_f2s(fast, train))
        return torch.cat([slow, fuse], dim=1), fast


class SlowFast(nn.Module):
    """Two-pathway ResNet with lateral fusion after s1/s2/s3/s4.

    ``forward(x)``: ``x`` [B, T, H, W, 3] → logits ``[B, num_classes]``
    float32."""

    def __init__(self, cfg: Optional[I3DConfig] = None, alpha: int = 8, beta_inv: int = 8,
                 fusion_ratio: int = 2, fusion_kernel: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg or I3DConfig()
        self.cfg, self.alpha, self.compute_dtype = c, alpha, dtype
        d2, d3, d4, d5 = STAGE_DEPTH[c.depth]
        w = c.width_per_group
        inner = c.num_groups * w
        out_ratio = beta_inv // fusion_ratio
        fuse = dict(ratio=fusion_ratio, kernel=fusion_kernel, alpha=alpha, bn_eps=c.bn_eps,
                    bn_momentum=c.bn_momentum)
        self.s1_slow = VideoStem(c.input_channels, w, SF_TEMP_KERNEL["slow"][0][0], c.bn_eps,
                                 c.bn_momentum)
        self.s1_fast = VideoStem(c.input_channels, w // beta_inv, SF_TEMP_KERNEL["fast"][0][0],
                                 c.bn_eps, c.bn_momentum)
        self.s1_fuse = FuseFastToSlow(w // beta_inv, **fuse)
        dims = [
            # (slow_in, slow_out, inner, blocks, n_temp, stride)
            (w, w * 4, inner, d2, c.num_block_temp_kernel[0], c.spatial_strides[0]),
            (w * 4, w * 8, inner * 2, d3, c.num_block_temp_kernel[1], c.spatial_strides[1]),
            (w * 8, w * 16, inner * 4, d4, c.num_block_temp_kernel[2], c.spatial_strides[2]),
            (w * 16, w * 32, inner * 8, d5, c.num_block_temp_kernel[3], c.spatial_strides[3]),
        ]
        bn = dict(zero_init_final_bn=c.zero_init_final_bn, bn_eps=c.bn_eps)
        for si, (din, dout, dinner, blocks, ntemp, stride) in enumerate(dims):
            self.add_module(f"s{si + 2}_slow", ResStage(
                din + din // out_ratio, dout, dinner, SF_TEMP_KERNEL["slow"][si + 1], blocks,
                ntemp, stride, **bn, bn_momentum=c.bn_momentum))
            self.add_module(f"s{si + 2}_fast", ResStage(
                din // beta_inv, dout // beta_inv, dinner // beta_inv,
                SF_TEMP_KERNEL["fast"][si + 1], blocks, ntemp, stride, **bn,
                bn_momentum=c.bn_momentum))
            if si < 3:   # fuse after s2/s3/s4; s5 goes straight to the head
                self.add_module(f"s{si + 2}_fuse", FuseFastToSlow(dout // beta_inv, **fuse))
        self.projection = nn.Linear(w * 32 + w * 32 // beta_inv, c.num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers: MSRA convolutions, BN ones/zeros
        (each block's final BN zeroed), the projection N(0, fc_init_std²)."""
        for m in self.modules():
            if isinstance(m, Conv3dBN):
                m.reset_parameters(generator)
        w = self.projection.weight
        w.copy_(torch.randn(w.shape, generator=generator) * self.cfg.fc_init_std)
        self.projection.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 4, 1, 2, 3)
        x = x.contiguous(memory_format=torch.channels_last_3d)
        slow = self.s1_slow(x[:, :, ::self.alpha], train)
        fast = self.s1_fast(x, train)
        slow, fast = self.s1_fuse(slow, fast, train)
        for si in range(4):
            slow = getattr(self, f"s{si + 2}_slow")(slow, train=train)
            fast = getattr(self, f"s{si + 2}_fast")(fast, train=train)
            if si < 3:
                slow, fast = getattr(self, f"s{si + 2}_fuse")(slow, fast, train)
        z = torch.cat([slow.float().mean(dim=(2, 3, 4)), fast.float().mean(dim=(2, 3, 4))], dim=1)
        if train:
            z = flax_dropout(z, self.cfg.dropout_rate, generator)
        return self.projection(z)


class Nonlocal(nn.Module):
    """Non-local block (the softmax or dot-product instantiation;
    nonlocal_helper.py:10). ``forward(x)``: NCTHW in and out."""

    def __init__(self, dim_in: int, dim_inner: int, instantiation: str = "softmax",
                 pool_size: Optional[Tuple[int, int, int]] = None, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(instantiation)
        self.dim_inner, self.instantiation, self.pool_size = dim_inner, instantiation, pool_size
        for name in ("conv_theta", "conv_phi", "conv_g"):
            self.add_module(name, nn.Conv3d(dim_in, dim_inner, 1))
        self.conv_out = nn.Conv3d(dim_inner, dim_in, 1)
        self.bn = nn.BatchNorm3d(dim_in, eps=bn_eps, momentum=bn_momentum)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's: lecun_normal convolutions with zero biases, the BN scale
        zero (the block starts as the identity)."""
        flax_reset_(self, generator)
        self.bn.weight.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, C, T, H, W = x.shape
        theta = self.conv_theta(x)
        xp = x
        if self.pool_size and any(s > 1 for s in self.pool_size):
            xp = max_pool_3d(x, self.pool_size, self.pool_size, (0, 0, 0))
        phi, g = self.conv_phi(xp), self.conv_g(xp)
        t, p, gg = (a.flatten(2).transpose(1, 2) for a in (theta, phi, g))   # [B, N, Ci]
        aff = torch.einsum("btc,bpc->btp", t, p)
        if self.instantiation == "softmax":
            aff = torch.softmax(aff * self.dim_inner ** -0.5, dim=2)
        else:
            aff = aff / aff.shape[2]
        out = torch.einsum("btp,bpc->btc", aff, gg)
        out = out.transpose(1, 2).reshape(B, self.dim_inner, T, H, W)
        return x + batch_norm(self.bn, self.conv_out(out), train)
