"""Dual-branch AU + landmark transformer (the "dualrun" second detector).

Port of ``stdd_tpu/models/dual_encoder.py`` (reference
``dualrun/model/dual_encoder.py``): ``grad_reverse`` :33, ``sinusoidal_pe``
:48, ``lengths_to_mask`` :59, ``AttentionPooling`` :75,
``TransformerLayer`` :91, ``BranchEncoder`` :124, ``DualEncoderAU_LMK``
:191 and ``LMKDisc`` :274.

The modules are named after the flax tree, so ``utils/weights.py`` bridges
them by name (``dual_flax_to_torch``). What flax does by default is
written out here:

- ``nn.LayerNorm`` has eps 1e-6; GELU is exact;
- ``MultiHeadDotProductAttention`` projects to ``[B, T, H, D/H]``, divides
  the query by ``sqrt(D/H)`` before the dot product, masks with the dtype's
  ``finfo.min`` (not ``-inf``), takes the softmax, drops out weights with
  one mask shared by the batch and the heads, and projects back from
  ``[H, D/H]``;
- the depthwise dilated ``nn.Conv`` is ``conv1d`` with ``groups=D``; the
  5-tap moving average pads with zeros and always divides by 5;
- the initializers are flax's (truncated-normal LeCun kernels, zero biases,
  unit LayerNorm scales, a unit-normal pooling query), drawn from a
  ``torch.Generator``.

Dropout draws its masks from the caller's ``torch.Generator``; a flax mask
cannot be drawn in torch. Masks are True where a token is PAD.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import global_rand

LN_EPS = 1e-6                      # flax nn.LayerNorm
HEAD_DROPOUT = 0.2                 # the binary head's dropout, fixed in the reference


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = float(lam)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


def grad_reverse(x: torch.Tensor, lam: float) -> torch.Tensor:
    """Identity forward, ``-lam · g`` backward, no gradient for ``lam``
    (the reference's GradReverse, DAT)."""
    return _GradReverse.apply(x, lam)


def sinusoidal_pe(T: int, d_model: int) -> torch.Tensor:
    """[T, d_model] float32 sine (even) / cosine (odd) position codes."""
    pos = torch.arange(T, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(T, d_model)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def lengths_to_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[B] int lengths or [B, T] validity (nonzero = valid) → [B, T] bool,
    True = PAD. A row with nothing valid keeps token 0 valid (the
    reference's ``lengths.clamp_min(1)``), in both forms."""
    if lengths.ndim == 2:
        pad = lengths == 0
        pad[:, 0] &= ~pad.all(dim=1)
        return pad
    ar = torch.arange(T, device=lengths.device)[None, :]
    return ar >= torch.clamp(lengths, min=1)[:, None]


def dropout(x: torch.Tensor, p: float, train: bool, generator: Optional[torch.Generator],
            shape=None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability ``1 - p`` and scale by
    ``1 / (1 - p)``; identity outside training or at ``p = 0``. ``shape``
    (default ``x.shape``) is the mask's, broadcast over ``x``; a mask of
    ``x``'s shape is, in a data-parallel block, this rank's rows of the
    global batch's (``parallel/mesh.py::global_rand``)."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - p
    if shape is None:
        mask = global_rand(x.shape, generator, x.device) < keep
    else:
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


def _lecun_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2 of its unit, times
    ``sqrt(1 / fan_in) / 0.8796…`` (the truncated unit normal's std)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """flax ``nn.Dense`` (weight ``[out, in]``, the kernel transposed;
    ``bias=False`` for ``use_bias=False``)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:                     # nn.Linear's constructor
            return super().reset_parameters()
        with torch.no_grad():
            _lecun_(self.weight, self.in_features, generator)
            if self.bias is not None:
                self.bias.zero_()


class LayerNorm(nn.LayerNorm):
    def __init__(self, d: int):
        super().__init__(d, eps=LN_EPS)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters()


class DepthwiseConv1d(nn.Module):
    """flax ``nn.Conv(D, kernel_size=(3,), padding=dil, kernel_dilation=dil,
    feature_group_count=D)`` over [B, D, T]: the kernel ``[3, 1, D]`` is
    the weight ``[D, 1, 3]``."""

    def __init__(self, d: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(d, 1, 3))
        self.bias = nn.Parameter(torch.empty(d))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _lecun_(self.weight, 3, generator)
            self.bias.zero_()

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, padding=self.dilation,
                        dilation=self.dilation, groups=x.shape[1])


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with ``qkv_features = D``:
    ``query``/``key``/``value`` hold the ``[D, H, D/H]`` kernels as
    ``[D, D]`` weights, ``out`` the ``[H, D/H, D]`` kernel."""

    def __init__(self, d_model: int, heads: int, dropout: float):
        super().__init__()
        self.heads, self.p = heads, dropout
        self.query, self.key, self.value, self.out = (Dense(d_model, d_model) for _ in range(4))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.query, self.key, self.value, self.out):
            m.reset_parameters(generator)

    def forward(self, x, pad_mask=None, train: bool = False, generator=None):
        B, T, D = x.shape
        H = self.heads
        q, k, v = (m(x).view(B, T, H, D // H) for m in (self.query, self.key, self.value))
        q = q / math.sqrt(D // H)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if pad_mask is not None:
            w = w.masked_fill(pad_mask[:, None, None, :], torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        w = dropout(w, self.p, train, generator, shape=(1, 1, T, T))
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, D)
        return self.out(a)


class TransformerLayer(nn.Module):
    """Pre-norm encoder layer (torch ``TransformerEncoderLayer`` with
    ``norm_first=True``, GELU feed-forward, key-padding mask)."""

    def __init__(self, d_model: int, heads: int, ff_dim: int, dropout: float):
        super().__init__()
        self.p = dropout
        self.norm1, self.norm2 = LayerNorm(d_model), LayerNorm(d_model)
        self.self_attn = SelfAttention(d_model, heads, dropout)
        self.linear1, self.linear2 = Dense(d_model, ff_dim), Dense(ff_dim, d_model)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.norm1, self.norm2, self.self_attn, self.linear1, self.linear2):
            m.reset_parameters(generator)

    def forward(self, x, pad_mask=None, train: bool = False, generator=None):
        a = self.self_attn(self.norm1(x), pad_mask, train, generator)
        x = x + dropout(a, self.p, train, generator)
        h = F.gelu(self.linear1(self.norm2(x)))
        h = self.linear2(dropout(h, self.p, train, generator))
        return x + dropout(h, self.p, train, generator)


class AttentionPooling(nn.Module):
    """Soft attention pooling with a learned query ``v`` and temperature."""

    def __init__(self, d_model: int, tau: float = 1.0):
        super().__init__()
        self.tau = tau
        self.v = nn.Parameter(torch.empty(d_model))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.v.copy_(torch.randn(self.v.shape, generator=generator))

    def forward(self, x, pad_mask=None):
        scores = (x @ self.v) / max(self.tau, 1e-3)
        if pad_mask is not None:
            scores = scores.masked_fill(pad_mask, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, dim=1)
        return torch.einsum("bt,btd->bd", w, x), w


class BranchEncoder(nn.Module):
    """Linear proj → LayerNorm → Δ + high-pass (vs a 5-tap moving average)
    temporal mix → dilated depthwise pyramid (d = 1, 2, 4) + residual →
    pointwise conv + GELU → sinusoidal PE → pre-norm transformer →
    attention pooling."""

    DILATIONS = (1, 2, 4)

    def __init__(self, input_dim: int, d_model: int = 256, depth: int = 4, heads: int = 4,
                 mlp_ratio: float = 2.0, dropout: float = 0.1, pool_tau: float = 0.7):
        super().__init__()
        self.d_model = d_model
        self.proj = Dense(input_dim, d_model)
        self.ln_in = LayerNorm(d_model)
        for i, dil in enumerate(self.DILATIONS):
            setattr(self, f"temporal{i}", DepthwiseConv1d(d_model, dil))
        self.pointwise = Dense(d_model, d_model)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"layer{i}",
                    TransformerLayer(d_model, heads, int(d_model * mlp_ratio), dropout))
        self.pool = AttentionPooling(d_model, pool_tau)
        self._pe = torch.empty(0)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.reset_parameters(generator)

    def position_codes(self, h: torch.Tensor) -> torch.Tensor:
        """``sinusoidal_pe`` for ``h``'s length, device and dtype, made once
        (the JAX program folds it in as a constant; a copy to the card each
        forward would wait for the stream)."""
        T = h.shape[1]
        if self._pe.shape[:1] != (T,) or self._pe.device != h.device or self._pe.dtype != h.dtype:
            self._pe = sinusoidal_pe(T, self.d_model).to(h)
        return self._pe

    def forward(self, x, pad_mask=None, train: bool = False, generator=None):
        """→ (pooled [B, D], pooling weights [B, T], sequence [B, T, D])."""
        h = self.ln_in(self.proj(x))
        delta = torch.cat([torch.zeros_like(h[:, :1]), h[:, 1:] - h[:, :-1]], dim=1)
        hp = F.pad(h, (0, 0, 2, 2))
        ma = (hp[:, :-4] + hp[:, 1:-3] + hp[:, 2:-2] + hp[:, 3:-1] + hp[:, 4:]) / 5.0
        h = h + 0.5 * delta + 0.5 * (h - ma)

        hc = h.transpose(1, 2)                                   # [B, D, T]
        pyr = 0.0
        for i in range(len(self.DILATIONS)):
            pyr = pyr + getattr(self, f"temporal{i}")(hc)
        h = pyr.transpose(1, 2) + h
        h = F.gelu(self.pointwise(h))

        h = h + self.position_codes(h)[None]
        for i in range(self.depth):
            h = getattr(self, f"layer{i}")(h, pad_mask, train, generator)
        clip, w = self.pool(h, pad_mask)
        return clip, w, h


class DualEncoderAU_LMK(nn.Module):
    """Two branch encoders (AU, landmarks) → concatenated embedding z →
    LayerNorm / MLP head → one logit; with ``use_dat`` and
    ``domain_classes > 0`` a domain head behind a gradient reversal. The
    auxiliary heads (``au_from_lmk``, ``proj_au``, ``proj_lmk``) exist with
    ``aux_heads=True``, as the flax model has them once initialised with
    ``need_aux=True``."""

    def __init__(self, au_dim: int = 36, lmk_dim: int = 132, d_model: int = 256, depth: int = 4,
                 heads: int = 4, mlp_ratio: float = 2.0, dropout: float = 0.1,
                 proj_dim: int = 128, use_dat: bool = False, domain_classes: int = 0,
                 pool_tau: float = 1.0, aux_heads: bool = False, seed: int = 0):
        super().__init__()
        self.heads, self.d_model, self.dropout_p = heads, d_model, dropout
        self.head_dropout = HEAD_DROPOUT
        self.au_enc = BranchEncoder(au_dim, d_model, depth, heads, mlp_ratio, dropout, pool_tau)
        self.lmk_enc = BranchEncoder(lmk_dim, d_model, depth, heads, mlp_ratio, dropout, pool_tau)
        self.head_ln = LayerNorm(2 * d_model)
        self.head_fc1 = Dense(2 * d_model, 2 * d_model)
        self.head_fc2 = Dense(2 * d_model, 1)
        self.domain_head = (Dense(2 * d_model, domain_classes)
                            if use_dat and domain_classes > 0 else None)
        self.aux_heads = aux_heads
        if aux_heads:
            self.au_from_lmk_ln = LayerNorm(d_model)
            self.au_from_lmk_fc = Dense(d_model, au_dim)
            self.proj_au = Dense(d_model, proj_dim)
            self.proj_lmk = Dense(d_model, proj_dim)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight with flax's initializers from ``generator``."""
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, A=None, L=None, lengths=None, train: bool = False, need_aux: bool = False,
                return_z: bool = False, return_seq: bool = False, dat_lambda: float = 0.0,
                z_override=None, generator: Optional[torch.Generator] = None,
                run_heads: bool = True) -> Dict[str, Any]:
        """The flax model's outputs (``bin_logits``, ``dom_logits``, and
        ``z``, ``za_seq``/``zl_seq``/``weights``, the aux heads and
        ``pad_mask`` as asked). ``z_override`` skips the encoders and runs
        the heads on a given [B, 2·d_model] embedding; ``run_heads=False``
        skips the heads (their outputs are then absent), for a caller that
        runs them again on another embedding."""
        if z_override is not None:
            z, pad = z_override, None
            za_seq = zl_seq = za_w = zl_w = None
        else:
            pad = lengths_to_mask(lengths, A.shape[1]) if lengths is not None else None
            za, za_w, za_seq = self.au_enc(A, pad, train, generator)
            zl, zl_w, zl_seq = self.lmk_enc(L, pad, train, generator)
            z = torch.cat([za, zl], dim=-1)

        out: Dict[str, Any] = {}
        if run_heads:
            h = F.gelu(self.head_fc1(self.head_ln(z)))
            h = dropout(h, self.head_dropout, train, generator)
            out["bin_logits"] = self.head_fc2(h)[:, 0]
            out["dom_logits"] = (self.domain_head(grad_reverse(z, dat_lambda))
                                 if self.domain_head is not None else None)
        if return_z:
            out["z"] = z
        if return_seq:
            out["za_seq"], out["zl_seq"] = za_seq, zl_seq
            out["weights"] = {"au": za_w, "lmk": zl_w}
        if need_aux:
            if not self.aux_heads:
                raise ValueError("need_aux: this model was built without aux_heads")
            out["au_pred"] = self.au_from_lmk_fc(self.au_from_lmk_ln(zl_seq))
            out["proj_au"] = self.proj_au(za_seq)
            out["proj_lmk"] = self.proj_lmk(zl_seq)
            out["pad_mask"] = pad
        return out


class LMKDisc(nn.Module):
    """Self-supervised landmark discriminator (reference dualrun/train/
    pretrain.py:51): one branch encoder and a binary head."""

    def __init__(self, lmk_dim: int = 132, d_model: int = 256, depth: int = 4, heads: int = 4,
                 dropout: float = 0.1, seed: int = 0):
        super().__init__()
        self.heads, self.d_model = heads, d_model
        self.enc = BranchEncoder(lmk_dim, d_model, depth, heads, dropout=dropout)
        self.head_ln = LayerNorm(d_model)
        self.head_fc = Dense(d_model, 1)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, L, lengths=None, train: bool = False, generator=None):
        pad = lengths_to_mask(lengths, L.shape[1]) if lengths is not None else None
        z, _, _ = self.enc(L, pad, train, generator)
        return self.head_fc(self.head_ln(z))[:, 0]
