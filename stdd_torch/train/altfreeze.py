"""AltFreezing, both rigs.

1. The I3D classifier (CVPR'23): alternate the temporal and the spatial
   convolutions every ``alter_freq`` iterations.
2. The dual encoder: epoch phases joint → A (train AU, freeze LMK) → B
   (train LMK, freeze AU) → … → joint tail (reference
   ``dualrun/train/altfreezing.py``; ``dual_labels`` :55,
   ``active_mask_from_labels`` :69, ``AltFreezeCfg`` :92, ``dual_phase``
   :100, ``dual_phase_active`` :113).

Port of ``stdd_tpu/train/altfreeze.py`` (``i3d_alt_labels``
:36, ``i3d_phase_mask`` :74, ``masked_update`` :125; reference
``slowfast/models/optimizer.py:12`` temporal_spatial_sep and :151
construct_optimizer_altertraining). The partition is by conv kernel shape:
[kt>1, 1, 1] kernels are temporal, [1, k>1, k] spatial, everything else (the
1×1×1 convolutions, the 5×7×7 stem, BN, the head) both. One optimizer
serves both phases: the inactive group's gradient is zeroed before the
optimizer and its update after it, so its values stay bit-identical while
its momentum keeps accumulating the decay term, as in JAX (Adam's moments of
a frozen leaf decay toward zero, as optax's do).

Trees are ``{name: tensor}`` dicts keyed by the model's parameter names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

TEMPORAL, SPATIAL, BOTH = "temporal", "spatial", "both"


def i3d_alt_labels(params: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """temporal / spatial / both for each parameter. A conv weight is
    ``[Cout, Cin, kt, kh, kw]`` (flax's kernel is ``[kt, kh, kw, Cin, Cout]``,
    so kt and kh sit at other indices)."""

    def label(p: torch.Tensor) -> str:
        if p.ndim == 5:
            kt, kh = p.shape[2], p.shape[3]
            if kt == 1 and kh > 1:
                return SPATIAL
            if kt > 1 and kh == 1:
                return TEMPORAL
        return BOTH                              # 1x1x1, the stem, BN, head

    return {k: label(p) for k, p in params.items()}


def i3d_phase_mask(labels: Dict[str, str], step: int, alter_freq: int) -> Dict[str, float]:
    """1.0 for a trained, 0.0 for a frozen parameter at iteration ``step``:
    even periods train the temporal group, odd periods the spatial one;
    'both' always trains."""
    train_temporal = (step // alter_freq) % 2 == 0
    active = {BOTH: True, TEMPORAL: train_temporal, SPATIAL: not train_temporal}
    return {k: 1.0 if active[lab] else 0.0 for k, lab in labels.items()}


def dual_labels(params: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """au / lmk / other for each dual-encoder parameter, by its branch."""
    def label(name: str) -> str:
        top = name.split(".")[0]
        return {"au_enc": "au", "lmk_enc": "lmk"}.get(top, "other")

    return {k: label(k) for k in params}


def active_mask_from_labels(labels: Dict[str, str], active: Tuple[str, ...]) -> Dict[str, float]:
    return {k: 1.0 if lab in active else 0.0 for k, lab in labels.items()}


@dataclass(frozen=True)
class AltFreezeCfg:
    enabled: bool = True
    warmup_epochs: int = 2
    period: int = 2
    joint_tail: int = 2
    start_epoch: int = 1


def dual_phase(cfg: AltFreezeCfg, epoch: int, last_epoch: int) -> str:
    """'joint', 'A' or 'B' for ``epoch`` (1-based) of ``last_epoch``."""
    if not cfg.enabled or epoch < cfg.start_epoch:
        return "joint"
    if epoch < cfg.start_epoch + cfg.warmup_epochs:
        return "joint"
    if epoch > max(cfg.start_epoch, last_epoch - cfg.joint_tail):
        return "joint"
    k = (epoch - cfg.start_epoch - cfg.warmup_epochs) // max(1, cfg.period)
    return "A" if k % 2 == 0 else "B"


def dual_phase_active(phase: str) -> Tuple[str, ...]:
    """The labels a phase trains: the heads always; A the AU branch, B the
    landmark branch."""
    if phase == "A":
        return ("au", "other")
    if phase == "B":
        return ("lmk", "other")
    return ("au", "lmk", "other")


def masked_update(tx, grads: Dict[str, torch.Tensor], opt_state, params: Dict[str, torch.Tensor],
                  active_mask: Dict[str, float]):
    """One optimizer step with frozen leaves: their gradients and their
    updates are multiplied by 0 (a trained leaf's by nothing, which is the
    same as by 1), then the updates are added to ``params`` in place.
    Returns the new optimizer state."""
    grads = {k: g if active_mask[k] == 1.0 else g * active_mask[k] for k, g in grads.items()}
    updates, new_state = tx.update(grads, opt_state, params)
    with torch.no_grad():
        for k, p in params.items():
            u = updates[k]
            p.add_(u if active_mask[k] == 1.0 else u * active_mask[k])
    return new_state
