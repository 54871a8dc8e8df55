"""FTCN — the Fully Temporal Convolution Network variant of the I3D.

Port of ``stdd_tpu/models/ftcn.py`` (the reference's ``ftcn_tt``
classifier, ``model/classifier/i3d_temporal_var_fix_dropout_tt_cfg.py``):
the I3D with every spatial kernel collapsed to 1×1 (each spatial stride-2
conv becomes stride 1 with a MaxPool(1,2,2) after its BN), the stages cut
at ``stop_point`` (the shipped ``ftcn_tt.yaml``: 5, so s2..s4) and a
TimeTransformer head: spatial average pool → T time tokens → a cls-token
pre-norm ViT (depth 1, 16 heads of 64, MLP 2048) → 1 logit.

- The trunk computes in the model's ``dtype`` over float32 parameters, in
  NCTHW ``channels_last_3d`` tensors, with the I3D's ``Conv3dBN``
  (``models/i3d.py``: eval BN as an affine, folded into the convolution
  on the card in 16 bits, train BN flax's); the head in
  float32, as JAX's.
- The head's attention is JAX's arithmetic: the bias-free ``qkv`` Linear,
  an einsum, a softmax, the einsum with ``v`` and ``attn_out``; LayerNorm
  with flax's epsilon 1e-6, GELU with flax's tanh approximation.
- Train mode applies the head's dropout (0.1, JAX's fixed rate; set
  ``model.head.dropout`` to change it) from the caller's
  ``torch.Generator``; the ``random`` and ``random_avg`` pools draw their
  interior sites from it too (``random_select``), unless the caller passes
  ``sites``.
- Served (``runtime/classifier.py``, ``arch="ftcn_tt"``): the eval forward
  returns the normed cls token beside the logits, runs the stages that
  ``cfg.int8_stages`` names through the int8 convolutions (s3 and s4 under
  the scorer's ``int8``), and records the head as the span
  ``stdd.scorer.head``. ``TemporalConvBN.stride_pools`` counts the max
  pools that stand in for a removed spatial stride (5 a forward of
  ``ftcn_tt``: the stem, then s3's and s4's first block, branch and
  shortcut).

Module names follow the flax tree, including its literal-slash block names
(``s2/pathway0_res0``) and flax's automatic ``Conv3dBN_0``, so
``utils/weights.py::flax_to_torch`` is a pure name map.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import I3DConfig
from ..utils.spans import span
from .i3d import (STAGE_DEPTH, Conv3dBN, finish_bn, flax_dropout, flax_reset_, join_residual,
                  max_pool_3d, stage_temp_kernels)
from .vit import LN_EPS, TransformerEncoder

PATCH_TYPES = ("time", "spatial", "random", "random_avg", "all")


class TemporalConvBN(nn.Module):
    """Tx1x1 conv (stride 1) → BN → optional MaxPool(1,2,2) standing in for
    a removed spatial stride (reference temporal_only_conv semantics). With
    BN folded (``Conv3dBN.folds``) the pool takes the convolution's output
    and BN's shift follows it, in the one pass that also applies the
    ReLU or the residual."""

    def __init__(self, dim_in: int, features: int, temp_kernel: int, spatial_pool: bool,
                 zero_init_scale: bool = False, bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 int8: bool = False):
        super().__init__()
        t = temp_kernel
        self.Conv3dBN_0 = Conv3dBN(dim_in, features, (t, 1, 1), (1, 1, 1), (t // 2, 0, 0),
                                   zero_init_scale, bn_eps, bn_momentum, int8)
        self.spatial_pool = spatial_pool

    # max pools standing in for a removed spatial stride, over the process's life
    stride_pools = 0

    def conv_bn(self, x, train: bool = False):
        """(y, shift) as :meth:`Conv3dBN.conv_bn`, y pooled where this
        stands in for a stride."""
        x, shift = self.Conv3dBN_0.conv_bn(x, train)
        if self.spatial_pool:
            TemporalConvBN.stride_pools += 1
            x = max_pool_3d(x, (1, 2, 2), (1, 2, 2), (0, 0, 0))
        return x, shift

    def forward(self, x, train: bool = False, relu: bool = False):
        return finish_bn(*self.conv_bn(x, train), relu=relu)


class FTCNBlock(nn.Module):
    """Temporal-only bottleneck residual block."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int, temp_kernel_size: int,
                 stride: int, bn_eps: float, bn_momentum: float, int8: bool = False):
        super().__init__()
        pool = stride == 2
        bn = dict(bn_eps=bn_eps, bn_momentum=bn_momentum, int8=int8)
        self.a = TemporalConvBN(dim_in, dim_inner, temp_kernel_size, False, **bn)
        self.b = TemporalConvBN(dim_inner, dim_inner, 1, pool, **bn)
        self.c = TemporalConvBN(dim_inner, dim_out, 1, False, zero_init_scale=True, **bn)
        self.shortcut = (TemporalConvBN(dim_in, dim_out, 1, pool, **bn)
                         if dim_in != dim_out or stride != 1 else None)

    def forward(self, x, train: bool = False):
        h = self.a(x, train, relu=True)
        h = self.b(h, train, relu=True)
        h, shift = self.c.conv_bn(h, train)
        return join_residual(h, shift, x, self.shortcut, train)


def _interior_indices(h: int, w: int) -> np.ndarray:
    """Spatial indices the random pools may pick (reference ``valid_idx`` at
    i3d_temporal_var_fix_dropout_tt_cfg.py:97; it divides by ``h`` for both
    coordinates, and so does this copy)."""
    return np.asarray([i for i in range(h * w)
                       if not (i % h == 0 or i // h == h - 1 or i % h == h - 1)], np.int64)


class TimeTransformerHead(TransformerEncoder):
    """Token pool → cls-token ViT → logits (reference TransformerHead at
    i3d_temporal_var_fix_dropout_tt_cfg.py:126 + time_transformer.py:219):
    the encoder's layers (``models/vit.py``) sit on the head itself, as in
    the flax tree.

    ``patch_type`` (reference :131-:147): ``time`` (spatial mean → T
    tokens, the shipped default), ``spatial`` (temporal mean → H·W tokens),
    ``random`` (one interior site: drawn in training with
    ``random_select``, the centre site otherwise), ``random_avg`` (the mean
    over ``k`` drawn interior sites in training with ``random_select``, over
    all of them otherwise), ``all`` (every T·H·W position)."""

    def __init__(self, num_patches: int, dim: int, depth: int = 1, heads: int = 16,
                 dim_head: int = 64, mlp_dim: int = 2048, dropout: float = 0.1,
                 num_classes: int = 1, patch_type: str = "time", random_select: bool = False,
                 k: int = 8):
        super().__init__(dim, depth, heads, dim_head, mlp_dim, dropout)
        if patch_type not in PATCH_TYPES:
            raise NotImplementedError(f"patch_type={patch_type!r}; one of {sorted(PATCH_TYPES)}")
        self.num_patches, self.dim = num_patches, dim
        self.patch_type, self.random_select, self.k = patch_type, random_select, k
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim))
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head_fc = nn.Linear(dim, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: the tokens N(0, 1), Dense lecun_normal with
        zero biases, LayerNorm ones and zeros."""
        for p in (self.cls_token, self.pos_embedding):
            p.copy_(torch.randn(p.shape, generator=generator))
        flax_reset_(self, generator)

    def pool(self, x: torch.Tensor, train: bool, generator: Optional[torch.Generator],
             sites: Optional[Sequence[int]]) -> torch.Tensor:
        """[B, T, H, W, C] float32 → tokens [B, N, C]."""
        B, T, H, W, C = x.shape
        if self.patch_type == "time":
            return x.mean(dim=(2, 3))
        if self.patch_type == "spatial":
            return x.mean(dim=1).reshape(B, H * W, C)
        if self.patch_type == "all":
            return x.reshape(B, T * H * W, C)
        flat = x.reshape(B, T, H * W, C)
        interior = torch.from_numpy(_interior_indices(H, W)).to(x.device)
        drawn = train and self.random_select
        if drawn and sites is None:
            if generator is None:
                raise ValueError("random_select draws its sites from a torch.Generator")
            n = len(interior)
            if self.patch_type == "random":
                pick = torch.randint(n, (1,), generator=generator, device=generator.device)
            else:
                pick = torch.randperm(n, generator=generator, device=generator.device)[:self.k]
            sites = interior[pick.to(x.device)]
        if self.patch_type == "random":
            site = int(sites[0]) if drawn else H * W // 2
            return flat[:, :, site, :]
        idx = torch.as_tensor(sites, device=x.device) if drawn else interior
        return flat[:, :, idx, :].mean(dim=2)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                sites: Optional[Sequence[int]] = None, return_features: bool = False):
        """``x`` [B, T, H, W, C] → logits [B, num_classes] float32; with
        ``return_features`` also the normed cls token [B, C] that
        ``head_fc`` reads."""
        x = self.pool(x.float(), train, generator, sites)
        B, N, _ = x.shape
        if N != self.num_patches:
            raise ValueError(f"{N} tokens, the head was built for {self.num_patches}")
        x = torch.cat([self.cls_token.expand(B, 1, self.dim), x], dim=1) + self.pos_embedding
        x = flax_dropout(x, self.dropout if train else 0.0, generator)
        x = super().forward(x, train, generator)
        feats = self.head_norm(x[:, 0])
        logits = self.head_fc(feats)
        return (logits, feats) if return_features else logits


def trunk_shape(cfg: I3DConfig) -> Tuple[int, int, int, int]:
    """(C, T, H, W) the FTCN trunk gives for a ``num_frames × crop_size²``
    clip: the stem's pool and max-pool, each stride-2 stage's pool and the
    temporal pool after s2."""
    c = cfg
    n_stages = max(1, min(4, c.stop_point - 2))
    T, H, W = c.num_frames, c.crop_size // 2, c.crop_size // 2
    H, W = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    for si in range(n_stages):
        if c.spatial_strides[si] == 2:
            H, W = H // 2, W // 2
        if si == 0 and c.t_pool_after_s2 > 1 and c.stop_point > 3:
            T //= c.t_pool_after_s2
    return c.width_per_group * 4 * 2 ** (n_stages - 1), T, H, W


class FTCN(nn.Module):
    """Temporal-only I3D trunk + TimeTransformer head.

    ``forward(x)``: ``x`` [B, T, H, W, 3] float (already normalized; T and
    H = W as ``cfg.num_frames``/``crop_size``, which fix the head's token
    count) → logits ``[B, num_classes]`` float32. ``cfg.int8_stages`` (eval
    only) runs the named stages it has through the int8 convolutions, as
    the I3D does; the stem never."""

    def __init__(self, cfg: Optional[I3DConfig] = None, patch_type: str = "time",
                 random_select: bool = False, patch_k: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg or I3DConfig(temporal_only=True)
        self.cfg, self.compute_dtype = c, dtype
        depths = STAGE_DEPTH[c.depth]
        w = c.width_per_group
        inner = c.num_groups * w
        bn = dict(bn_eps=c.bn_eps, bn_momentum=c.bn_momentum)
        # stem: the [5,1,1] conv (spatial 7x7 removed) + the pool for the
        # removed stride; the stem's own 1x3x3 max-pool follows in forward
        self.s1 = TemporalConvBN(c.input_channels, w, c.temp_kernel[0][0], True, **bn)
        stage_dims = [(w, w * 4, inner), (w * 4, w * 8, inner * 2),
                      (w * 8, w * 16, inner * 4), (w * 16, w * 32, inner * 8)]
        # reference truncation: s_i → Identity for stop_point <= i
        # (i3d_temporal_var_fix_dropout_tt_cfg.py:315-330)
        self.block_names = []
        for si in range(max(1, min(4, c.stop_point - 2))):
            di, do, dinner = stage_dims[si]
            tks = stage_temp_kernels(c.temp_kernel[si + 1], depths[si],
                                     c.num_block_temp_kernel[si])
            for bi in range(depths[si]):
                name = f"s{si + 2}/pathway0_res{bi}"
                self.add_module(name, FTCNBlock(di if bi == 0 else do, do, dinner, tks[bi],
                                                c.spatial_strides[si] if bi == 0 else 1, **bn,
                                                int8=f"s{si + 2}" in c.int8_stages))
                self.block_names.append(name)
        # pathway0_pool after s2; stop_point==3 keeps the reference's
        # Identity in its place (:320)
        self.t_pool_after = (f"s2/pathway0_res{depths[0] - 1}"
                             if c.t_pool_after_s2 > 1 and c.stop_point > 3 else None)
        C, T, H, W = trunk_shape(c)
        n_tokens = {"time": T, "random": T, "random_avg": T, "spatial": H * W,
                    "all": T * H * W}
        if patch_type not in n_tokens:
            raise NotImplementedError(f"patch_type={patch_type!r}; one of {sorted(n_tokens)}")
        self.head = TimeTransformerHead(n_tokens[patch_type], C, num_classes=c.num_classes,
                                        patch_type=patch_type, random_select=random_select,
                                        k=patch_k)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initializers (MSRA conv fill, BN ones/zeros with
        each block's final BN zeroed, flax's head), drawn from
        ``generator``."""
        for m in self.modules():
            if isinstance(m, Conv3dBN):
                m.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                sites: Optional[Sequence[int]] = None, return_features: bool = False,
                bottleneck=None):
        """``train``: batch statistics in every BN (moving the running
        ones), the head's dropout and ``random_select``'s draws, all from
        ``generator``; ``sites`` replaces those draws. ``return_features``:
        (logits, the normed cls token [B, C] float32). ``bottleneck`` is
        the scorer's K2 entry point, accepted and unused: K2 computes a 3×3
        middle and these blocks are 1×1×1."""
        x = x.to(self.compute_dtype).permute(0, 4, 1, 2, 3)
        x = x.contiguous(memory_format=torch.channels_last_3d)
        x = self.s1(x, train, relu=True)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
            if name == self.t_pool_after:
                tp = self.cfg.t_pool_after_s2
                x = max_pool_3d(x, (tp, 1, 1), (tp, 1, 1), (0, 0, 0))
        x = x.permute(0, 2, 3, 4, 1)
        if train:
            return self.head(x, train, generator, sites, return_features)
        with span("stdd.scorer.head"):
            return self.head(x, False, generator, sites, return_features)
