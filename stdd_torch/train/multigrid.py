"""Multigrid training schedule (Wu et al., "A Multigrid Method for
Efficiently Training Video Models").

Own copy of ``stdd_tpu/train/multigrid.py`` (``MultigridConfig``,
``MultigridSchedule`` with ``long_cycle_shape``, ``update``,
``short_cycle_spatial`` and ``lr_boundaries`` :134), itself a rebuild of
``slowfast/utils/multigrid.py:13`` (MultigridSchedule): long cycles step
(B, T, S) through LONG_CYCLE_FACTORS with batch sizes chosen to keep
B·T·S² ≈ constant; short cycles additionally shrink S per-iteration
(``get_long_cycle_schedule`` :123, ``update_long_cycle`` :64,
``get_current_long_cycle_shape`` :223). The epoch-boundary bookkeeping —
step-LR boundaries scaled by EPOCH_FACTOR, the halved fine-tuning phase, and
the iteration-saving-matched tail — follows ``init_multigrid`` :18.

The schedule is computed once up front, so every (B, T, S) the run will
take is known before training starts; on the card each shape is a fresh
cuDNN algorithm choice, not a recompile. ``lr_boundaries``' leading 0 is
the convention ``train/lr_policy.py``'s step table takes. The reference's
sub-batch BN re-typing (:88-:104) is not needed: one card computes the
batch's BN statistics over the whole batch at any batch size.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

Shape = Tuple[int, int, int]   # (batch_factor·B, T, S)


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Mirror of the MULTIGRID config node (slowfast/config/defaults.py)."""

    long_cycle: bool = True
    short_cycle: bool = False
    long_cycle_factors: Tuple[Tuple[float, float], ...] = (
        (0.25, 0.7071), (0.5, 0.7071), (0.5, 1.0), (1.0, 1.0),
    )
    short_cycle_factors: Tuple[float, float] = (0.5, 0.7071)
    epoch_factor: float = 1.5
    default_b: int = 8
    default_t: int = 32
    default_s: int = 224
    solver_steps: Tuple[int, ...] = (0, 16, 24)
    solver_max_epoch: int = 30
    gamma: float = 0.1
    base_lr: float = 0.1


@dataclasses.dataclass
class MultigridSchedule:
    """Static long-cycle schedule: list of (step_index, (b, t, s), end_epoch)."""

    cfg: MultigridConfig
    schedule: List[Tuple[int, Shape, int]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.cfg.long_cycle and not self.schedule:
            self.schedule = self._long_cycle_schedule()

    # -- schedule construction (reference get_long_cycle_schedule :123) -------

    def _shapes_for(self, t_factor: float, s_factor: float) -> List[Shape]:
        c = self.cfg
        base_t = int(round(c.default_t * t_factor))
        base_s = int(round(c.default_s * s_factor))
        if c.short_cycle:
            shapes = [
                (base_t, int(c.default_s * c.short_cycle_factors[0])),
                (base_t, int(c.default_s * c.short_cycle_factors[1])),
                (base_t, base_s),
            ]
        else:
            shapes = [(base_t, base_s)]
        default_size = float(c.default_t * c.default_s ** 2)
        return [(int(round(default_size / (t * s * s))), t, s) for t, s in shapes]

    def _long_cycle_schedule(self) -> List[Tuple[int, Shape, int]]:
        c = self.cfg
        steps = list(c.solver_steps)
        all_shapes = [self._shapes_for(t, s) for t, s in c.long_cycle_factors]
        avg_bs = [sum(s[0] for s in shapes) / len(shapes) for shapes in all_shapes]

        total_iters = 0.0
        raw: List[Tuple[int, Shape, float]] = []
        for si in range(len(steps) - 1):
            step_epochs = steps[si + 1] - steps[si]
            for ci, shapes in enumerate(all_shapes):
                cur_epochs = step_epochs * avg_bs[ci] / sum(avg_bs)
                total_iters += cur_epochs / avg_bs[ci]
                raw.append((si, shapes[-1], cur_epochs))

        iter_saving = steps[-1] / total_iters
        ft_epochs = (c.solver_max_epoch - steps[-1]) / iter_saving * avg_bs[-1]
        raw.append((len(steps) - 1, all_shapes[-1][-1], ft_epochs))

        x = c.solver_max_epoch * c.epoch_factor / sum(r[2] for r in raw)
        out, total = [], 0.0
        for si, shape, ep in raw:
            total += ep * x
            out.append((si, shape, int(round(total))))
        return out

    # -- queries (reference update_long_cycle :64 / get_current... :223) ------

    @property
    def max_epoch(self) -> int:
        return self.schedule[-1][-1] if self.schedule else self.cfg.solver_max_epoch

    def long_cycle_shape(self, epoch: int) -> Shape:
        """(batch_factor, T, S) for this epoch; batch = factor × default_b."""
        for _, shape, end in self.schedule:
            if epoch < end:
                return shape
        return self.schedule[-1][1]

    def update(self, epoch: int, prev_shape: Optional[Shape] = None
               ) -> Tuple[Shape, bool]:
        """→ (shape, changed): changed=True means the input pipeline and the
        step must be rebuilt at the new shape (reference returns (cfg, True)
        and rebuilds the loader, train_net.py)."""
        shape = self.long_cycle_shape(epoch)
        return shape, shape != prev_shape

    def short_cycle_spatial(self, cur_iter: int, s_long: int) -> int:
        """Per-iteration spatial size inside a short cycle (the 3-phase
        S·0.5 / S·0.7071 / S pattern; loader-side in the reference)."""
        if not self.cfg.short_cycle:
            return s_long
        phase = cur_iter % 3
        if phase == 0:
            return int(self.cfg.default_s * self.cfg.short_cycle_factors[0])
        if phase == 1:
            return int(self.cfg.default_s * self.cfg.short_cycle_factors[1])
        return s_long

    def lr_boundaries(self) -> Tuple[List[int], List[float]]:
        """Step-LR boundaries/values matching init_multigrid (:36-:50):
        per-cycle LR = gamma^step_index × batch_factor, with the halved
        fine-tuning boundary and the doubled tail value."""
        c = self.cfg
        steps = [0] + [s[-1] for s in self.schedule]
        steps[-1] = (steps[-2] + steps[-1]) // 2
        lrs = [c.gamma ** s[0] * s[1][0] for s in self.schedule]
        lrs = lrs[:-1] + [lrs[-2], lrs[-1]]
        return steps, [l * c.base_lr for l in lrs]
