"""Tri-modal RGB fusion models (the reference's dualrun/rgb extension).

Port of ``stdd_tpu/models/dual_rgb.py``: ``masked_mean`` :24,
``DualEncoderRGB`` :33 and ``GatedMoE`` :74, on the dual encoder's pieces
(``models/dual_encoder.py``: ``BranchEncoder``, ``lengths_to_mask``, flax's
LayerNorm with eps 1e-6, exact GELU and flax's initializers drawn from a
``torch.Generator``).

- :class:`DualEncoderRGB` (ref ``dualrun/model/dual_rgb.py:47``): trainable
  AU and landmark branch encoders beside a frozen RGB branch (per-clip I3D
  features [B, T, D], masked-mean pooled, through ``rgb_proj``), one head
  over 3·d_model. JAX stops the gradient at the features and after
  ``rgb_proj``; here the features are detached and ``rgb_proj`` does not
  require gradients.
- :class:`GatedMoE` (ref ``dualrun/rgb/engine_rgb.py:369``): late fusion of
  two per-video logits with a learned gate and a temperature per expert.

``utils/weights.py`` bridges both to the flax trees (``dual_flax_to_torch``
for ``DualEncoderRGB``, ``moe_flax_to_torch`` for ``GatedMoE``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dual_encoder import BranchEncoder, Dense, LayerNorm, dropout, lengths_to_mask


def masked_mean(z: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over time of [B, T, D] with a [B, T] True = PAD mask; a row
    with nothing valid gives zeros (its weights' sum is clamped to 1e-6)."""
    if pad_mask is None:
        return z.mean(dim=1)
    valid = (~pad_mask).float()
    w = valid / torch.clamp(valid.sum(dim=1, keepdim=True), min=1e-6)
    return torch.einsum("bt,btd->bd", w.to(z.dtype), z)


class DualEncoderRGB(nn.Module):
    """AU and landmark branch encoders (pooling temperature 0.7, the
    ``BranchEncoder`` default the JAX model keeps) and the frozen RGB
    branch → z [B, 3·d_model] → LayerNorm → fc1 (2·d_model) → GELU →
    dropout → fc2 → one logit. It takes the per-clip features only, as the
    JAX model does (``from_features=True``)."""

    def __init__(self, au_dim: int = 36, lmk_dim: int = 132, vis_dim: int = 2048,
                 d_model: int = 256, depth: int = 4, heads: int = 4, mlp_ratio: float = 2.0,
                 dropout: float = 0.1, seed: int = 0):
        super().__init__()
        self.heads, self.d_model, self.dropout_p = heads, d_model, dropout
        self.au_enc = BranchEncoder(au_dim, d_model, depth, heads, mlp_ratio, dropout)
        self.lmk_enc = BranchEncoder(lmk_dim, d_model, depth, heads, mlp_ratio, dropout)
        self.rgb_proj = Dense(vis_dim, d_model, bias=False)
        self.head_ln = LayerNorm(3 * d_model)
        self.head_fc1 = Dense(3 * d_model, 2 * d_model)
        self.head_fc2 = Dense(2 * d_model, 1)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.rgb_proj.requires_grad_(False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight with flax's initializers from ``generator``."""
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, A, L, rgb_feats, lengths=None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """A [B, T, au_dim], L [B, T, lmk_dim], rgb_feats [B, T, vis_dim]
        → ``{"bin_logits": [B], "z": [B, 3·d_model]}``."""
        pad = lengths_to_mask(lengths, A.shape[1]) if lengths is not None else None
        za, _, _ = self.au_enc(A, pad, train, generator)
        zl, _, _ = self.lmk_enc(L, pad, train, generator)
        zv = self.rgb_proj(masked_mean(rgb_feats.float().detach(), pad)).detach()
        z = torch.cat([za, zl, zv], dim=-1)
        h = F.gelu(self.head_fc1(self.head_ln(z)))
        h = dropout(h, self.dropout_p, train, generator)
        return {"bin_logits": self.head_fc2(h)[:, 0], "z": z}


class GatedMoE(nn.Module):
    """Gated late fusion of (RGB logit, dual logit) [B, 1] each:
    ``p = g·σ(z_rgb / max(t_rgb, 1)) + (1 − g)·σ(z_dual / max(t_dual, 0.1))``
    with ``g`` from a 3 → hidden → 1 MLP over (z_rgb, z_dual, |z_rgb −
    z_dual|); returns ``(log((p + 1e-6) / (1 − p + 1e-6)), g)``, both
    [B, 1]. The temperatures start at 1. ``torch.maximum`` splits the
    gradient at a tie as ``jnp.maximum`` does (``t_rgb`` starts on one)."""

    def __init__(self, hidden: int = 8, seed: int = 0):
        super().__init__()
        self.t_rgb = nn.Parameter(torch.ones(()))
        self.t_dual = nn.Parameter(torch.ones(()))
        self.gate_fc1 = Dense(3, hidden)
        self.gate_fc2 = Dense(hidden, 1)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.t_rgb.fill_(1.0)
            self.t_dual.fill_(1.0)
        self.gate_fc1.reset_parameters(generator)
        self.gate_fc2.reset_parameters(generator)

    def forward(self, z_rgb: torch.Tensor, z_dual: torch.Tensor):
        x = torch.cat([z_rgb, z_dual, (z_rgb - z_dual).abs()], dim=1)
        g = torch.sigmoid(self.gate_fc2(F.relu(self.gate_fc1(x))))
        one, tenth = self.t_rgb.new_tensor(1.0), self.t_dual.new_tensor(0.1)
        p = (g * torch.sigmoid(z_rgb / torch.maximum(self.t_rgb, one))
             + (1 - g) * torch.sigmoid(z_dual / torch.maximum(self.t_dual, tenth)))
        eps = 1e-6
        return torch.log((p + eps) / (1 - p + eps)), g
