"""The training state and the flattening loss of the I3D trainer.

Port of ``TrainState`` and ``bce_with_logits`` (``stdd_tpu/train/step.py:28,43``).
In JAX the state is an immutable pytree that each step replaces; here
``params`` and ``batch_stats`` are the model's own parameter and running
statistic tensors (a step updates them in place), ``opt_state`` is the
optimizer chain's state (``engine_i3d.make_i3d_optimizer``) and ``step``
the host's iteration count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from .losses import bce_with_logits as _bce


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Any
    step: int

    @classmethod
    def of(cls, model: nn.Module, opt_state: Any, step: int = 0) -> "TrainState":
        """The state over ``model``'s parameters and BN running statistics."""
        stats = {k: b for k, b in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return cls(dict(model.named_parameters()), stats, opt_state, step)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The shared loss over flattened logits and labels."""
    return _bce(logits.reshape(-1), labels.reshape(-1))
