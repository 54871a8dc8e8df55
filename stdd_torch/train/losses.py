"""Training losses: the binary cross entropy both trainers use, and the
dual encoder's loss zoo.

Port of ``stdd_tpu/train/losses.py``: ``bce_with_logits`` :16 (reference
``slowfast/models/losses.py``), ``binary_focal_loss`` :52, ``alignment``
:79, ``uniformity`` :96, ``mse_masked`` :106, ``temporal_infonce`` :114,
``log1mexp`` :142 and ``noisy_or_group_logits`` :151 (reference
``dualrun/train/losses.py``, ``engine.py:157,204``). Every loss keeps the
JAX version's static shapes: masked entries are zeroed or set to ``-inf``,
never gathered away.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: Optional[float] = None,
                    reduction: str = "mean") -> torch.Tensor:
    """Numerically stable binary cross entropy on raw logits, in float32.

    Shapes must match exactly; the one exception is a trailing class axis
    of 1 on ``logits`` (a one-unit head) against targets of one rank less,
    which is squeezed. A silent (B,1)×(B,) broadcast would make the loss a
    (B,B) matrix whose gradient teaches the batch's base rate: the JAX
    package found that on the chip as an AUC of 0.5 after 1350 steps on
    separable data."""
    logits = logits.float()
    targets = targets.float()
    if logits.ndim == targets.ndim + 1 and logits.shape[-1] == 1:
        logits = logits[..., 0]
    if logits.shape != targets.shape:
        raise ValueError(f"bce_with_logits: logits {tuple(logits.shape)} vs targets "
                         f"{tuple(targets.shape)} must match (no broadcasting)")
    per = F.relu(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if pos_weight is not None:
        per = per * torch.where(targets == 1, pos_weight, 1.0)
    return _reduce(per, reduction)


def _reduce(per: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def binary_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                      alpha: Optional[float] = None, reduction: str = "mean") -> torch.Tensor:
    """``(1 − p_t)^γ``-modulated BCE with optional α class weighting, with
    :func:`bce_with_logits`'s shape check."""
    if logits.ndim == targets.ndim + 1 and logits.shape[-1] == 1:
        logits = logits[..., 0]
    targets = targets.float()
    bce = bce_with_logits(logits, targets, reduction="none")
    p = torch.sigmoid(logits.float())
    pt = torch.clamp(torch.where(targets == 1, p, 1 - p), 1e-6, 1 - 1e-6)
    loss = (1 - pt) ** gamma * bce
    if alpha is not None:
        loss = torch.where(targets == 1, alpha * loss, (1 - alpha) * loss)
    return _reduce(loss, reduction)


def _pair_d2(x: torch.Tensor) -> torch.Tensor:
    return ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)


def alignment(embeddings: torch.Tensor, labels: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """Label-aware alignment (Wang & Isola 2020): the mean ``||x − y||^α``
    over same-label pairs i < j; 0 without such pairs."""
    n = embeddings.shape[0]
    if n < 2:
        return embeddings.new_zeros(())
    upper = torch.ones(n, n, dtype=torch.bool, device=embeddings.device).triu(1)
    same = (labels[:, None] == labels[None, :]) & upper
    dist_pow = torch.sqrt(torch.clamp(_pair_d2(embeddings), min=1e-12)) ** alpha
    cnt = same.sum()
    total = torch.where(same, dist_pow, torch.zeros_like(dist_pow)).sum()
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1), torch.zeros_like(total))


def uniformity(x: torch.Tensor, t: float = 2.0, clip_value: float = 1e-6) -> torch.Tensor:
    """``log mean exp(−t·||xi − xj||²)`` over the pairs i < j."""
    n = x.shape[0]
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    e = torch.exp(-t * _pair_d2(x))
    mean = torch.where(mask, e, torch.zeros_like(e)).sum() / max(n * (n - 1) // 2, 1)
    return torch.log(torch.clamp(mean, min=clip_value))


def mse_masked(pred: torch.Tensor, target: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked MSE over [B, T, D]; ``mask`` [B, T] True = keep."""
    if mask is None:
        return ((pred - target) ** 2).mean()
    m = mask[..., None].float()
    return ((pred - target) ** 2 * m).sum() / torch.clamp(m.sum(), min=1.0)


def temporal_infonce(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor],
                     temperature: float = 0.1) -> torch.Tensor:
    """Frame-level InfoNCE between two branch projections. ``q``, ``k``
    [B, T, P]; ``mask`` [B, T] True = PAD: PAD keys get ``-inf`` logits and
    PAD rows no weight."""
    B, T, P = q.shape
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    k = k / torch.clamp(torch.linalg.norm(k, dim=-1, keepdim=True), min=1e-12)
    logits = (q.reshape(B * T, P) @ k.reshape(B * T, P).T) / temperature
    valid = (torch.ones(B * T, dtype=torch.bool, device=q.device) if mask is None
             else ~mask.reshape(B * T))
    logits = logits.masked_fill(~valid[None, :], -math.inf)
    diag = torch.diagonal(torch.log_softmax(logits, dim=1))
    per_row = torch.where(valid, -diag, torch.zeros_like(diag))
    return per_row.sum() / torch.clamp(valid.sum(), min=1)


def log1mexp(x: torch.Tensor) -> torch.Tensor:
    """``log(1 − exp(x))`` for x ≤ 0, in its stable form on each side of
    −ln 2."""
    return torch.where(x < -0.69314718056, torch.log1p(-torch.exp(x)),
                       torch.log(-torch.expm1(x)))


def noisy_or_group_logits(logits: torch.Tensor, group_ids: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Per-group noisy-OR in logit space over dense ids in
    [0, num_groups): ``logit(1 − ∏(1 − p_i))`` over each group's clips.
    Groups without members come out at ``log1mexp(−1e-8) + 1e-8`` and are
    masked by the caller."""
    s = torch.zeros(num_groups, dtype=logits.dtype, device=logits.device).index_add(
        0, group_ids, F.logsigmoid(-logits))
    return log1mexp(torch.clamp(s, max=-1e-8)) - s
