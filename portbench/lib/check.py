"""What the output check of every kind shares: the compared number, the
sample it is taken over, and the faults a test plants under the timed path."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch


def stratified_pick(items: Sequence, want: int, rng: np.random.Generator) -> List:
    """One item drawn from each of ``want`` equal consecutive strata of
    ``items``, so the sample spreads over the whole window."""
    want = min(want, len(items))
    edges = np.linspace(0, len(items), want + 1)
    return [items[int(rng.integers(int(a), max(int(a) + 1, int(b))))]
            for a, b in zip(edges[:-1], edges[1:])]


def signed_gaps(probs: np.ndarray, ref_logit: np.ndarray, ref_feats: np.ndarray, head_w
                ) -> np.ndarray:
    """program logit − reference logit of each window, as a share of
    rms(head weight) × |reference features|: the standard deviation of the
    logit over random heads, so the number does not depend on the weights'
    scale. A probability of 0 or 1 (a logit float32 cannot resolve) reads
    as infinite."""
    p = np.asarray(probs, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.log(p) - np.log1p(-p)
    scale = float(head_w.double().pow(2).mean().sqrt()) * np.linalg.norm(ref_feats, axis=1)
    gap = (lg - ref_logit) / scale
    return np.where(np.isfinite(gap), gap, math.inf)


FAULTS = ("half_batch", "altered_answer")


def plant_fault(scorer, fault: str) -> None:
    """Break the scorer's timed path underneath (``ClipScorer._score_impl``,
    which every entry point calls), for the test that the check sees it."""
    impl = scorer._score_impl

    if fault == "half_batch":
        # half of each batch left out, its probabilities the mean of the rest
        def broken(crops, boxes, lm5, valid, scale=None, **kw):
            h = max(1, crops.shape[0] // 2)
            p = impl(crops[:h], boxes[:h], lm5[:h], valid[:h],
                     None if scale is None else scale[:h], **kw)
            return torch.cat([p, p.mean().expand(crops.shape[0] - h)])
    elif fault == "altered_answer":
        # one probability of each batch altered where it is produced
        def broken(*a, **kw):
            p = impl(*a, **kw).clone()
            p[0] = torch.sigmoid(torch.logit(p[0].double()) + 0.25).to(p.dtype)
            return p
    else:
        raise ValueError(f"unknown fault {fault!r}; the check is tested against {FAULTS}")
    scorer._score_impl = broken
