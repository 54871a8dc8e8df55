"""Video transformer variants of the reference's ViT zoo.

Port of ``stdd_tpu/models/vit.py`` (reference
``model/classifier/time_transformer.py``): the pre-norm encoder
(``Attention`` :36 / ``Transformer`` :74), ``VideoiT`` (:167: each spatial
patch an independent T-step sequence, with RandomSelect :146 over the
interior patches in training) and ``SpatialTemporal_Transformer`` (:281:
factorized space-then-time attention). float32, as the JAX modules; the
attention is JAX's arithmetic (bias-free ``qkv``, einsum, softmax, einsum,
``attn_out``), LayerNorm with flax's epsilon 1e-6, GELU with its tanh
approximation; dropout is flax's, drawn from the caller's
``torch.Generator``, and so are RandomSelect's patches unless the caller
passes ``sites``. Module names follow the flax tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .i3d import flax_dropout, flax_reset_

LN_EPS = 1e-6          # flax nn.LayerNorm's default


class TransformerEncoder(nn.Module):
    """Pre-norm ViT encoder (reference Transformer, time_transformer.py:74)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.depth, self.heads, self.dim_head, self.dropout = depth, heads, dim_head, dropout
        inner = heads * dim_head
        for i in range(depth):
            self.add_module(f"attn_norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"qkv{i}", nn.Linear(dim, inner * 3, bias=False))
            self.add_module(f"attn_out{i}", nn.Linear(inner, dim))
            self.add_module(f"mlp_norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"mlp_fc1_{i}", nn.Linear(dim, mlp_dim))
            self.add_module(f"mlp_fc2_{i}", nn.Linear(mlp_dim, dim))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B = x.shape[0]
        rate = self.dropout if train else 0.0
        inner = self.heads * self.dim_head
        for i in range(self.depth):
            h = getattr(self, f"attn_norm{i}")(x)
            q, k, v = getattr(self, f"qkv{i}")(h).chunk(3, dim=-1)
            q, k, v = (t.reshape(B, -1, self.heads, self.dim_head).transpose(1, 2)
                       for t in (q, k, v))
            att = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * self.dim_head ** -0.5,
                                dim=-1)
            o = torch.einsum("bhij,bhjd->bhid", att, v).transpose(1, 2).reshape(B, -1, inner)
            x = x + flax_dropout(getattr(self, f"attn_out{i}")(o), rate, generator)
            h = getattr(self, f"mlp_norm{i}")(x)
            h = F.gelu(getattr(self, f"mlp_fc1_{i}")(h), approximate="tanh")
            h = getattr(self, f"mlp_fc2_{i}")(flax_dropout(h, rate, generator))
            x = x + flax_dropout(h, rate, generator)
        return x


def extract_patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, T, H, W, C] → [B, T, (H/p)(W/p), p·p·C] (the Rearrange at
    time_transformer.py:174/:294, channels last)."""
    B, T, H, W, C = x.shape
    x = x.reshape(B, T, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, T, (H // p) * (W // p), p * p * C)


def interior_patch_indices(n: int) -> np.ndarray:
    """Interior patch ids for RandomSelect (reference valid_idx at
    time_transformer.py:134: a ``h // 7``-wide border goes on the left, the
    right and the bottom, as the reference's test reads; below 7×7 every
    patch is valid)."""
    h = int(n ** 0.5)
    pad = h // 7
    return np.asarray([i for i in range(n)
                       if not (i % h < pad or i // h >= h - pad or i % h >= h - pad)], np.int64)


class VideoiT(nn.Module):
    """Per-patch time transformer (reference VideoiT,
    time_transformer.py:167): every (randomly selected, in training with
    ``random_select``) interior patch is a T-step sequence classified on its
    own; ``forward(x)``: [B, T, H, W, 3] → [B, n_selected·num_classes]."""

    def __init__(self, image_size: int, patch_size: int, num_frames: int, num_classes: int = 1,
                 dim: int = 256, depth: int = 2, heads: int = 8, dim_head: int = 64,
                 mlp_dim: int = 1024, dropout: float = 0.0, emb_dropout: float = 0.0,
                 pool: str = "cls", random_select: bool = False, k: int = 8, channels: int = 3):
        super().__init__()
        assert image_size % patch_size == 0
        self.patch_size, self.num_frames, self.dim = patch_size, num_frames, dim
        self.emb_dropout, self.pool, self.random_select, self.k = emb_dropout, pool, random_select, k
        self.patch_to_embedding = nn.Linear(patch_size * patch_size * channels, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_frames + 1, dim))
        self.transformer = TransformerEncoder(dim, depth, heads, dim_head, mlp_dim, dropout)
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_head = nn.Linear(dim, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: tokens N(0, 1), Dense lecun_normal."""
        for p in (self.cls_token, self.pos_embedding):
            p.copy_(torch.randn(p.shape, generator=generator))
        flax_reset_(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                sites: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``sites``: the patches RandomSelect keeps in training (drawn from
        ``generator`` when None)."""
        B = x.shape[0]
        patches = extract_patches(x.float(), self.patch_size).transpose(1, 2)   # [B,N,T,pd]
        sel = torch.from_numpy(interior_patch_indices(patches.shape[1])).to(x.device)
        if train and self.random_select:                                   # RandomSelect :146
            if sites is None:
                if generator is None:
                    raise ValueError("random_select draws its patches from a torch.Generator")
                pick = torch.randperm(len(sel), generator=generator, device=generator.device)
                sites = sel[pick[:self.k].to(x.device)]
            sel = torch.as_tensor(sites, device=x.device)
        patches = patches[:, sel]                                         # [B,n,T,pd]
        n = patches.shape[1]
        seq = self.patch_to_embedding(patches.reshape(B * n, self.num_frames, -1))
        seq = torch.cat([self.cls_token.expand(B * n, 1, self.dim), seq], dim=1) + self.pos_embedding
        seq = flax_dropout(seq, self.emb_dropout if train else 0.0, generator)
        seq = self.transformer(seq, train, generator)
        feat = seq.mean(dim=1) if self.pool == "mean" else seq[:, 0]
        return self.mlp_head(self.head_norm(feat)).reshape(B, -1)      # ref :214


class SpatialTemporalTransformer(nn.Module):
    """Factorized space→time ViT (reference SpatialTemporal_Transformer,
    time_transformer.py:281): a per-frame spatial encoder with a space cls
    token, the frames' cls tokens through a temporal encoder with its own;
    the patch embedding is an explicit Linear, as in the JAX module.
    ``forward(x)``: [B, T, H, W, 3] → [B, num_classes]."""

    def __init__(self, image_size: int, patch_size: int, num_frames: int, num_classes: int = 1,
                 dim: int = 192, depth: int = 4, heads: int = 3, dim_head: int = 64,
                 scale_dim: int = 4, dropout: float = 0.0, emb_dropout: float = 0.0,
                 pool: str = "cls", channels: int = 3):
        super().__init__()
        assert image_size % patch_size == 0
        n = (image_size // patch_size) ** 2
        self.patch_size, self.dim, self.emb_dropout, self.pool = patch_size, dim, emb_dropout, pool
        self.patch_to_embedding = nn.Linear(patch_size * patch_size * channels, dim)
        self.space_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_frames, n + 1, dim))
        self.space_transformer = TransformerEncoder(dim, depth, heads, dim_head,
                                                    dim * scale_dim, dropout)
        self.temporal_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.temporal_transformer = TransformerEncoder(dim, depth, heads, dim_head,
                                                       dim * scale_dim, dropout)
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_head = nn.Linear(dim, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: tokens N(0, 1), Dense lecun_normal."""
        for p in (self.space_token, self.pos_embedding, self.temporal_token):
            p.copy_(torch.randn(p.shape, generator=generator))
        flax_reset_(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T = x.shape[:2]
        patches = self.patch_to_embedding(extract_patches(x.float(), self.patch_size))
        N = patches.shape[2]
        x = torch.cat([self.space_token.expand(B, T, 1, self.dim), patches], dim=2)
        x = x + self.pos_embedding[:, :T, :N + 1]
        x = flax_dropout(x, self.emb_dropout if train else 0.0, generator)
        x = self.space_transformer(x.reshape(B * T, N + 1, self.dim), train, generator)
        x = x[:, 0].reshape(B, T, self.dim)                  # the frames' cls tokens
        x = torch.cat([self.temporal_token.expand(B, 1, self.dim), x], dim=1)
        x = self.temporal_transformer(x, train, generator)
        feat = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return self.mlp_head(self.head_norm(feat))
