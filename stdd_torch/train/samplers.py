"""Balanced per-technique epoch samplers (host-side index logic).

Own copy of ``stdd_tpu/train/samplers.py`` (pure Python ``random``, so one
seed gives the same index sequence in both packages); ports of the
reference ``dualrun/train/samplers.py``:
- :class:`BalancedPerTechSampler` (ref ``:23`` BalancedPerTechBaseSampler):
  each epoch yields N indices = ½ real ½ fake, fakes split per manipulation
  technique with multiplicative boosts, min quotas and a water-filling
  correction to hit exactly N/2.
- :class:`BalancedPerTechLOOSampler` (ref ``:136``): excludes a held-out
  technique. NOTE: the reference relabels held-out fakes as real inside the
  sampler, which leaks them into the real half while the dataset still serves
  label=1; here they are excluded from sampling entirely (the intended LOO
  semantics).
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional


def _cycle_pick(pool: List[int], k: int, rng: random.Random) -> List[int]:
    """Sample k with maximal coverage, re-permuting when k > |pool|
    (samplers.py:6)."""
    n = len(pool)
    if n == 0:
        return []
    out: List[int] = []
    need = k
    start = rng.randrange(n)
    cur = pool[:]
    while need > 0:
        rng.shuffle(cur)
        cur = cur[start:] + cur[:start]
        take = min(need, n)
        out.extend(cur[:take])
        need -= take
        start = rng.randrange(n)
    return out


class BalancedPerTechSampler:
    def __init__(
        self,
        labels: List[int],
        tech_names: List[str],
        epoch_samples: int,
        seed_base: int = 0,
        reshuffle_each_epoch: bool = True,
        boosts: Optional[Dict[str, float]] = None,
        min_quota: int = 0,
        exclude_tech: Optional[str] = None,
    ):
        assert epoch_samples > 0 and epoch_samples % 2 == 0
        self.labels = labels
        self.tech_names = [(t or "unknown").lower() for t in tech_names]
        self.N = int(epoch_samples)
        self.seed = int(seed_base)
        self.reshuffle = bool(reshuffle_each_epoch)
        self.boosts = {
            (k or "unknown").lower(): float(v) for k, v in (boosts or {}).items()
        }
        self.min_quota = int(min_quota)
        excl = (exclude_tech or "").lower()

        self.real_idx = [i for i, y in enumerate(labels) if y == 0]
        self.fake_idx = [
            i
            for i, y in enumerate(labels)
            if y == 1 and (not excl or self.tech_names[i] != excl)
        ]
        if not self.real_idx or not self.fake_idx:
            raise ValueError("train split must contain both real and fake samples")

        tech2idx: Dict[str, List[int]] = {}
        for i in self.fake_idx:
            tech2idx.setdefault(self.tech_names[i], []).append(i)
        self.tech2idx = {t: v for t, v in tech2idx.items() if v}
        self.techs = sorted(self.tech2idx)
        self._rng = random.Random(self.seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return self.N

    def __iter__(self) -> Iterator[int]:
        rng = self._rng
        rng.seed(self.seed + self._epoch * 10007 + 17)
        half = self.N // 2

        weights = [max(self.boosts.get(t, 1.0), 1e-6) for t in self.techs]
        wsum = sum(weights)
        quota = {
            t: max(self.min_quota, int(round(half * w / wsum)))
            for t, w in zip(self.techs, weights)
        }
        # water-filling to hit exactly `half` (samplers.py:96-115)
        total = sum(quota.values())
        if total != half:
            order = sorted(self.techs, key=lambda t: len(self.tech2idx[t]), reverse=True)
            diff = half - total
            step = 1 if diff > 0 else -1
            diff = abs(diff)
            j = 0
            while diff > 0 and order:
                t = order[j % len(order)]
                if step < 0 and quota[t] <= self.min_quota:
                    j += 1
                    if j >= 10 * len(order):
                        break
                    continue
                quota[t] += step
                diff -= 1
                j += 1

        fakes: List[int] = []
        for t in self.techs:
            pool = self.tech2idx[t][:]
            if self.reshuffle:
                rng.shuffle(pool)
            k = quota[t]
            fakes.extend(rng.sample(pool, k) if k <= len(pool) else _cycle_pick(pool, k, rng))

        real_pool = self.real_idx[:]
        if self.reshuffle:
            rng.shuffle(real_pool)
        reals = (
            rng.sample(real_pool, half)
            if half <= len(real_pool)
            else _cycle_pick(real_pool, half, rng)
        )

        merged = reals + fakes
        rng.shuffle(merged)
        return iter(merged)


class BalancedPerTechLOOSampler(BalancedPerTechSampler):
    def __init__(self, labels, tech_names, heldout: str, epoch_samples: int, **kw):
        super().__init__(
            labels, tech_names, epoch_samples, exclude_tech=heldout, **kw
        )
