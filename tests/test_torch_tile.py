"""The port's largest-tile picker (``stdd_torch/runtime/sources.py``
``LargestTilePicker`` and ``iter_roi``) against the JAX package's, whose
cv2 calls are the oracle: the same rectangles over one picker's sequence of
frames (grid layouts whose tiles the edges cut out, frames with no tile
above ``min_area_frac`` that fall back on motion, and the first call's whole
frame), and the same crops from ``iter_roi``."""

import numpy as np
import pytest

from stdd_tpu.runtime import sources as jax_sources
from stdd_torch.runtime import sources


def smooth(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 60 * np.sin(xx / (6.0 + seed) + c) * np.cos(yy / 9.0 - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 3, 0, 255).astype(np.uint8)


def speaker_grid(h, w, seed):
    """A speaker layout: a large tile on the left and two small ones on the
    right, filling the frame between 2-px gutters that reach its edges."""
    f = np.full((h, w, 3), 20, np.uint8)
    big_w = (w * 2) // 3
    f[:, :big_w - 1] = smooth(h, big_w - 1, seed)
    f[: h // 2 - 1, big_w + 1:] = smooth(h // 2 - 1, w - big_w - 1, seed + 1)
    f[h // 2 + 1:, big_w + 1:] = smooth(h - h // 2 - 1, w - big_w - 1, seed + 2)
    return f


def frames(h=72, w=120):
    rng = np.random.RandomState(0)
    noise = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(3)]
    moving = []
    for i in range(3):                       # motion only: a block moves over noise
        f = noise[0].copy()
        f[10 + 3 * i:30 + 3 * i, 20 + 5 * i:50 + 5 * i] = 255
        moving.append(f)
    still = noise[0].copy()
    still[:2] = 0                            # below the motion threshold's count
    return ([noise[0], speaker_grid(h, w, 1), speaker_grid(h, w, 4), noise[1], noise[2]]
            + moving + [still, speaker_grid(h, w, 7)[:, ::-1].copy()])


@pytest.mark.parametrize("min_area_frac,motion_thresh", [(0.08, 12.0), (0.6, 12.0),
                                                         (0.08, 200.0)])
def test_picks_equal_jax_over_a_sequence(min_area_frac, motion_thresh):
    ours = sources.LargestTilePicker(min_area_frac, motion_thresh)
    theirs = jax_sources.LargestTilePicker(min_area_frac, motion_thresh)
    picks = []
    for f in frames():
        got, want = ours.pick(f), theirs.pick(f)
        assert got == want and all(type(v) is int for v in got), (len(picks), got, want)
        picks.append(got)
    if min_area_frac == 0.08 and motion_thresh == 12.0:
        H, W = frames()[0].shape[:2]
        assert picks[0] == (0, 0, W, H)                          # no reference yet
        assert picks[1][2] - picks[1][0] < W                     # a tile, not the frame
        assert picks[3] != (0, 0, W, H)                          # motion fallback


def test_iter_roi_equals_jax():
    fs = frames()
    got = list(sources.iter_roi(iter(fs), repick_every=2))
    want = list(jax_sources.iter_roi(iter(fs), repick_every=2))
    assert len(got) == len(want) == len(fs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
