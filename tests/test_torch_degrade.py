"""The port's cv2-free degradations and host resize against the JAX
package's cv2 calls (``stdd_torch/data/degrade.py`` vs
``stdd_tpu/data/degrade.py``; ``stdd_torch/ops/align.py::resize_u8`` vs
``cv2.resize``).

Tolerance: none. Every operation, and so :class:`ClipDegrader`, is
bit-equal to the JAX package's on the same frames and seeds (the same
number of frames, the same pixels): the resize in both modes, both area
paths (the tables of a fractional ratio and an integer factor's fast
path), the integer shift, the 1/k row filter, OpenCV 5.0's 15-bit gray
conversion, and the numpy operations JAX shares.
"""

import random

import cv2
import numpy as np
import pytest

import stdd_tpu.data.degrade as J
import stdd_torch.data.degrade as P
from stdd_torch.ops.align import resize_u8


def _img(hw, seed, channels=3):
    shape = hw if channels is None else hw + (channels,)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("src,dst,channels", [
    ((48, 64), (97, 131), 3), ((97, 131), (48, 64), 3), ((37, 53), (71, 29), 3),
    ((121, 161), (256, 256), 3), ((300, 301), (256, 256), 3), ((5, 7), (3, 2), None),
    ((1, 9), (4, 5), 1), ((64, 96), (32, 48), 4), ((63, 95), (21, 19), None),
], ids=["up", "down", "mixed", "to256_up", "to256_down", "tiny_gray", "one_row",
        "half_rgba", "odd_gray"])
@pytest.mark.parametrize("mode", ["linear", "area"])
def test_resize_u8_matches_cv2(src, dst, channels, mode):
    img = _img(src, sum(src), channels)
    if mode == "area" and (dst[0] > src[0] or dst[1] > src[1]):
        with pytest.raises(ValueError, match="upscales"):
            resize_u8(img, dst, mode)
        return
    flag = cv2.INTER_LINEAR if mode == "linear" else cv2.INTER_AREA
    want = cv2.resize(img, dst[::-1], interpolation=flag)
    got = resize_u8(img, dst, mode)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert got.shape == dst + img.shape[2:]


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_resize_u8_integer_area_factors_match_cv2(factor):
    """The fast path: 2× rounds ``(sum + 2) >> 2``, 3× and 4× round
    ``sum · (1/n)`` half to even; a 2× INTER_LINEAR takes it too."""
    img = _img((24 * factor, 36 * factor), factor)
    for mode, flag in (("area", cv2.INTER_AREA), ("linear", cv2.INTER_LINEAR)):
        want = cv2.resize(img, (36, 24), interpolation=flag)
        np.testing.assert_array_equal(resize_u8(img, (24, 36), mode), want)


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (121, 161)], ids=["even", "odd", "wide"])
def test_each_degradation_matches_jax(hw):
    img = _img(hw, hw[0])
    for s in (0.5, 0.55, 0.73, 0.95, 0.999):
        np.testing.assert_array_equal(P.down_up(img, s), J.down_up(img, s), err_msg=f"scale {s}")
    for k in (0, 3, 5, 7):
        np.testing.assert_array_equal(P.motion_blur(img, k), J.motion_blur(img, k),
                                      err_msg=f"blur {k}")
    np.testing.assert_array_equal(P.grayscale(img), J.grayscale(img))
    for seed, frac in enumerate((0.0, 0.04, 0.08, 0.3)):
        got = P.offcenter_crop(img, frac, random.Random(seed))
        np.testing.assert_array_equal(got, J.offcenter_crop(img, frac, random.Random(seed)))
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    np.testing.assert_array_equal(P.gauss_noise(img, 6.0, a), J.gauss_noise(img, 6.0, b))
    assert a.randint(1 << 30) == b.randint(1 << 30)
    for seed in range(3):
        r, q = random.Random(seed), random.Random(seed)
        np.testing.assert_array_equal(P.gamma_contrast(img, r), J.gamma_contrast(img, q))
        np.testing.assert_array_equal(P.letterbox(img, r), J.letterbox(img, q))
        assert r.random() == q.random()


def test_grayscale_matches_cv2_on_every_colour():
    """OpenCV 5.0's BGR2GRAY is (9798·R + 19235·G + 3735·B + 2^14) >> 15 on
    all 2^24 colours."""
    colours = np.arange(1 << 24, dtype=np.uint32).view(np.uint8).reshape(4096, 4096, 4)[..., :3]
    colours = np.ascontiguousarray(colours)
    want = cv2.cvtColor(colours, cv2.COLOR_BGR2GRAY)
    got = P.grayscale(colours)
    np.testing.assert_array_equal(got[..., 0], want)
    assert (got == got[..., :1]).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_clip_degrader_matches_jax(seed):
    """Eight frames of an odd size through both chains at their defaults:
    the same frames kept (drops included) and the same pixels."""
    rng = np.random.RandomState(100 + seed)
    frames = [rng.randint(0, 256, (67, 93, 3)).astype(np.uint8) for _ in range(8)]
    got = P.ClipDegrader(seed=seed)(frames)
    want = J.ClipDegrader(seed=seed)(frames)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_clip_degrader_options_match_jax():
    """Non-default options: every probability at 1 but the drop (all draws
    taken), an even blur floor, a narrow scale; then the whole clip dropped
    but its first frame."""
    rng = np.random.RandomState(7)
    frames = [rng.randint(0, 256, (50, 70, 3)).astype(np.uint8) for _ in range(6)]
    kw = dict(jpeg_q=(60, 60), scale=(0.6, 0.7), mblur_k=(4, 9), p_grayscale=1.0,
              p_gauss_noise=1.0, p_letterbox=1.0, p_gamma_contrast=1.0, seed=11)
    for extra in ({}, {"p_frame_drop": 1.0}):
        got = P.ClipDegrader(**kw, **extra)(frames)
        want = J.ClipDegrader(**kw, **extra)(frames)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
