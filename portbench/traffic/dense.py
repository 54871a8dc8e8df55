"""Offline dense scoring: the analyst's mode, a closed loop over face tracks.

Traffic (the mix file's parameters):

- ``track_frames``: the lengths of the tracks, the same set for every seed;
  the seed orders them and draws their content and geometry. Lengths with
  ``(n - clip) % batch == 0`` leave no padded batch slot, so a seed changes
  which tracks a window holds and not the work per window;
- ``stride``, ``batch``: the window step and the batch of ``score_dense``;
- ``face_px``: the range of face sizes in the crop (its big box is twice
  that, inside the crop buffer, so no track is scaled down);
- ``drift_px``, ``jitter_px``: the face's motion per frame in the frame, and
  the landmarks' per-frame jitter;
- ``check_pairs``: how many pairs of neighbouring windows the output check
  recomputes.

Set-up packs every track as planar I420 in host memory (made on the card
from the seed, copied back once) and warms ``score_dense`` on each of them
at the window's batch shape. The window scores whole tracks, one after
another, each through ``ClipScorer.score_dense`` with its upload and its
final sync inside, until ``--seconds`` have passed; ``clips_per_s`` is every
window scored over the whole window's time.

The check recomputes ``check_pairs`` pairs of neighbouring windows, drawn
from the seed across every track the window scored, with the plain
reference, and compares the program's logit (from its probability) with
the reference's, as a share of the logit's natural scale (``lib/check.py``).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.lib import flops
from portbench.lib.check import plant_fault, signed_gaps, stratified_pick
from portbench.lib.program import build_scorer
from portbench.lib.trace import Window
from portbench.reference.align import TEMPLATE_256
from portbench.reference.scorer import logits_and_features

SALT_CONTENT = 0x5EED_0001
SALT_CHECK = 0x5EED_0002


def _smooth(gen, shape, size, device):
    """Random field of ``shape`` [C, K, r, r] upsampled to ``size``
    (trilinear), one value per output voxel, unit-ish scale."""
    z = torch.randn((1,) + tuple(shape), generator=gen, device=device)
    return F.interpolate(z, size=size, mode="trilinear", align_corners=True)[0]


def make_track(gen, rng: np.random.Generator, n: int, S: int, mix: dict, device
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One track: (I420 crops [n, 3S/2, S] uint8, big boxes [n, 4], crop-local
    landmarks [n, 5, 2]) float32. The content changes brightness, contrast,
    colour and texture over the track, so windows far apart are unlike."""
    lo, hi = mix["face_px"]
    f = float(rng.uniform(lo, hi))
    side = int(round(2 * f))                 # the big box: the face box grown by half a side each way
    keys = n // 24 + 2
    r = int(rng.integers(3, 25))
    tex = _smooth(gen, (1, keys, r, r), (n, S, S), device)[0]
    mean = 118 + 60 * torch.tanh(_smooth(gen, (1, keys, 1, 1), (n, 1, 1), device)[0])
    contrast = 30 * torch.exp(0.6 * _smooth(gen, (1, keys, 1, 1), (n, 1, 1), device)[0])
    grain = torch.randn((n, S, S), generator=gen, device=device)
    y = (mean + contrast * tex + 4 * grain).clamp_(16, 235)
    rc = int(rng.integers(2, 9))
    uv = 128 + torch.as_tensor(rng.uniform(-25, 25, (2, 1, 1, 1)), dtype=torch.float32,
                               device=device) \
        + 18 * _smooth(gen, (2, keys, rc, rc), (n, S // 2, S // 2), device)
    uv = uv.clamp_(16, 240)
    # the crop buffer beyond the big box is the packer's zero padding: black
    y[:, side:, :] = 16
    y[:, :, side:] = 16
    uv[:, :, side // 2:, :] = 128
    uv[:, :, :, side // 2:] = 128
    planar = torch.empty((n, S * 3 // 2, S), dtype=torch.uint8, device=device)
    planar[:, :S] = y.round().to(torch.uint8)
    planar[:, S:S + S // 4] = uv[0].round().to(torch.uint8).reshape(n, S // 4, S)
    planar[:, S + S // 4:] = uv[1].round().to(torch.uint8).reshape(n, S // 4, S)
    frames = planar.cpu().numpy()

    d = mix["drift_px"]
    start = rng.uniform((200, 150), (1500, 700))
    vel = rng.uniform(-d, d, 2)
    face_xy = start + np.cumsum(vel + rng.normal(0, d / 3, (n, 2)), 0)
    x1y1 = np.rint(face_xy - f / 2)
    boxes = np.concatenate([x1y1, x1y1 + side], 1).astype(np.float32)
    j = mix["jitter_px"]
    lm5 = (f / 2 + TEMPLATE_256 * (f / 256.0))[None] + rng.uniform(-j, j, (n, 5, 2))
    return frames, boxes, lm5.astype(np.float32)


class Run:
    def __init__(self, cell, seed: int, device, variant=None, fault=None):
        self.cell, self.seed, self.device = cell, seed, device
        mix = cell.mix
        self.mix = mix
        torch.backends.cudnn.allow_tf32 = False          # as the program's CLIs set it
        self.scorer, self.params, self.spec = build_scorer(cell.config, seed, device, variant)
        if fault is not None:
            plant_fault(self.scorer, fault)
        S = cell.config["serving"]["crop_buffer"]
        self.T = self.spec.frames
        self.batch = mix["batch"]
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=device)
        gen.manual_seed((seed ^ SALT_CONTENT) & 0xFFFF_FFFF_FFFF_FFFF)
        lengths = list(mix["track_frames"])
        for n in lengths:
            if ((n - self.T) // mix["stride"] + 1) % self.batch:
                raise ValueError(f"a track of {n} frames leaves a padded batch slot")
        self.tracks = [make_track(gen, rng, lengths[k], S, mix, device)
                       for k in rng.permutation(len(lengths))]
        self.starts = [np.arange(0, len(t[0]) - self.T + 1, mix["stride"]) for t in self.tracks]
        for (frames, boxes, lm5) in self.tracks:              # every track's upload and batch shape
            self.scorer.score_dense(frames, boxes, lm5, self.starts[0][:self.batch],
                                    batch=self.batch)
        self.crop_buffer, self.out_size = S, self.spec.crop

    def window(self, seconds: float, trace: bool) -> dict:
        from stdd_torch.ops import warp

        scored: List[Tuple[int, np.ndarray]] = []
        k1_before = warp.warp_affine.launches
        with Window(trace, self.device) as w:
            t0 = w.t0
            i = 0
            while True:
                k = i % len(self.tracks)
                frames, boxes, lm5 = self.tracks[k]
                with torch.profiler.record_function("portbench.score_dense"):
                    probs = self.scorer.score_dense(frames, boxes, lm5, self.starts[k],
                                                    batch=self.batch)
                scored.append((k, probs))
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        self.scored = scored
        n = sum(len(p) for _, p in scored)
        failed = sum(int((~np.isfinite(p)).sum()) for _, p in scored)
        k1_launches = warp.warp_affine.launches - k1_before
        k1_frames = sum(len(self.starts[k]) for k, _ in scored) * self.T
        return {
            "kind": "dense", "t0": t0, "window_s": w.seconds, "attempted": n, "failed": failed,
            "missing": failed,
            "clips": n, "flops_per_clip": flops.i3d_flops(self.spec),
            "k1_launches": k1_launches,
            "k1_bytes": k1_frames * flops.k1_bytes_per_frame(self.crop_buffer, self.out_size),
            "trace": w.trace,
            "e2e": {"clips_per_s": {"value": n / w.seconds, "unit": "clips/s"}},
        }

    def check(self) -> List[Tuple[str, float, float]]:
        """Free the program, recompute pairs of neighbouring windows with the
        reference: ``logit_gap``, the widest gap of a window's logit, and
        ``step_gap``, the widest gap of the change of logit from a window to
        the next (what the two windows share cancels in it, the weights'
        rounding above all, so it reads each window's own error)."""
        del self.scorer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        pairs = [(r, s) for r, (k, p) in enumerate(self.scored) for s in range(len(p) - 1)]
        rng = np.random.default_rng([self.seed & 0xFFFF_FFFF_FFFF_FFFF, SALT_CHECK])
        windows, probs = [], []
        for r, s in stratified_pick(pairs, self.mix["check_pairs"], rng):
            k, p = self.scored[r]
            frames, boxes, lm5 = self.tracks[k]
            for j in (s, s + 1):
                a = self.starts[k][j]
                windows.append((frames[a:a + self.T], boxes[a:a + self.T], lm5[a:a + self.T]))
                probs.append(float(p[j]))
        eps = self.cell.config["model"]["bn_eps"]
        ref_logits, ref_feats = logits_and_features(self.params, self.spec, windows, eps,
                                                    self.device)
        d = signed_gaps(np.asarray(probs), ref_logits[:, 0], ref_feats,
                        self.params["head.projection.weight"])
        self.gaps, self.steps = np.abs(d), np.abs(d[1::2] - d[0::2])
        lim = self.cell.limits
        return [("logit_gap", float(self.gaps.max()), lim["logit_gap"]),
                ("step_gap", float(self.steps.max()), lim["step_gap"])]
