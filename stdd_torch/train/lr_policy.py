"""Learning-rate policies (reference slowfast/utils/lr_policy.py:9-98).

Port of ``stdd_tpu/train/lr_policy.py``: epoch-continuous schedules (cosine,
relative steps, step decay), each wrapped in a linear warmup from
``warmup_start_lr``, as callables over the fractional epoch (step /
steps_per_epoch). ``engine_i3d.make_lr_schedule`` tabulates them per step.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def cosine_lr(base_lr: float, max_epoch: float) -> Callable[[float], float]:
    def fn(cur_epoch: float) -> float:
        return base_lr * 0.5 * (math.cos(math.pi * cur_epoch / max_epoch) + 1.0)

    return fn


def steps_with_relative_lrs(base_lr: float, steps: Sequence[float], lrs: Sequence[float],
                            max_epoch: float) -> Callable[[float], float]:
    """Piecewise-constant relative LRs over epoch milestones, in the
    reference's index convention (lr_policy.py:60,:75): ``steps`` carries a
    leading zero, ``len(lrs) == len(steps)``, and an epoch below
    ``steps[i]`` (the first such) takes ``lrs[i - 1]``."""
    if len(lrs) != len(steps):
        raise ValueError(
            f"steps_with_relative_lrs: len(lrs)={len(lrs)} must equal "
            f"len(steps)={len(steps)} (reference lr_policy.py:60 convention)")
    if not steps or steps[0] != 0:
        # without the leading zero an epoch below steps[0] would read lrs[-1]
        raise ValueError(
            f"steps_with_relative_lrs: steps must carry a leading 0 (got {list(steps)!r})")
    bounds = list(steps) + [max_epoch]

    def fn(cur_epoch: float) -> float:
        ind = len(bounds) - 1
        for i, b in enumerate(bounds):
            if cur_epoch < b:
                ind = i
                break
        return base_lr * lrs[ind - 1]

    return fn


def step_decay(base_lr: float, step_size: float, gamma: float) -> Callable[[float], float]:
    """LR_POLICY 'step' of the FTCN solver (SOLVER.STEP_SIZE/GAMMA)."""

    def fn(cur_epoch: float) -> float:
        return base_lr * gamma ** math.floor(cur_epoch / step_size)

    return fn


def with_warmup(policy: Callable[[float], float], warmup_epochs: float,
                warmup_start_lr: float) -> Callable[[float], float]:
    """Linear warmup toward the policy's value at the warmup's end
    (lr_policy.py:9-32 get_lr_at_epoch)."""

    def fn(cur_epoch: float) -> float:
        lr = policy(cur_epoch)
        if cur_epoch < warmup_epochs:
            lr_end = policy(warmup_epochs)
            alpha = (lr_end - warmup_start_lr) / warmup_epochs
            lr = cur_epoch * alpha + warmup_start_lr
        return lr

    return fn
