"""The port's host plane against the JAX package: the quality gate, the
native helpers (the port's own build, not the JAX package's library), the
clip packing without cv2, and the device ring's windows on a CPU device."""

import cv2
import numpy as np
import pytest
import torch

from stdd_tpu.ops.quality import crop_quality as jax_crop_quality
from stdd_tpu.runtime.packing import pack_clip_batch as jax_pack_clip_batch
from stdd_torch import native
from stdd_torch.ops.quality import crop_quality, half_res_area, variance_of_laplacian_np
from stdd_torch.runtime.packing import _area_resize_np, pack_clip_batch
from stdd_torch.runtime.ring import DeviceRing, RingKernels, RingUploader


def _crops(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), np.uint8)
            for h, w in ((96, 80), (57, 131), (200, 180), (33, 33))]


def test_native_library_is_the_ports_own_build():
    if not native.available():
        pytest.skip("no C++ compiler: the port takes its numpy twins")
    lib = native._load()
    assert "stdd_torch" in lib._name and "stdd_tpu" not in lib._name


def test_crop_quality_matches_jax():
    """Gate weight and size as the JAX package's; the blur metric within the
    1e-3 its own native-vs-numpy test allows (its prebuilt library differs
    from its numpy twin by ~1e-4 on odd sizes), and equal to the numpy twin
    here to 1e-9."""
    for crop in _crops():
        got = crop_quality(crop)
        want = jax_crop_quality(crop)
        assert got[:2] == want[:2]
        assert got[2] == pytest.approx(want[2], rel=1e-3)
        assert variance_of_laplacian_np(half_res_area(crop)) == pytest.approx(got[2], rel=1e-9)


def test_area_resize_matches_cv2():
    """The packing's resize (native, or the numpy twin) against cv2's
    INTER_AREA, which the JAX package packs with: at most 1 grey level."""
    rng = np.random.RandomState(1)
    src = rng.randint(0, 256, (300, 280, 3), np.uint8)
    for scale in (0.85, 0.5, 0.37):
        oh, ow = int(300 * scale), int(280 * scale)
        want = cv2.resize(src, (ow, oh), interpolation=cv2.INTER_AREA).astype(int)
        assert np.abs(_area_resize_np(src, oh, ow).astype(int) - want).max() <= 1
        if native.available():
            dst = np.zeros((256, 256, 3), np.uint8)
            assert native.resize_area_pack(src, dst, scale)
            assert np.abs(dst[:oh, :ow].astype(int) - want).max() <= 1
            assert dst[oh:].max() == 0 and dst[:, ow:].max() == 0


@pytest.mark.parametrize("yuv420", [False, True], ids=["rgb", "yuv420"])
def test_pack_clip_batch_matches_jax(yuv420):
    """Clips packed without cv2 against the JAX package's packing (cv2's
    resize and I420 encoder): the same geometry, pixels within 1 grey level
    where a crop is downscaled (3 in I420, whose chroma subsampling picks
    one pixel of each 2×2 block) and exact where it is not."""
    rng = np.random.RandomState(2)
    S, T = 128, 4
    clips = []
    for size in ((100, 90), (300, 260)):                # fits / is downscaled
        clip = []
        for t in range(T):
            clip.append(dict(crop=rng.randint(0, 256, size + (3,), np.uint8),
                             big_box=np.array([10.0 + t, 20.0, 10.0 + t + size[1], 20.0 + size[0]],
                                              np.float32),
                             lm5=rng.uniform(10, 80, (5, 2)).astype(np.float32)))
        clips.append(clip)
    got = pack_clip_batch(clips, 3, T, S, yuv420=yuv420)
    want = jax_pack_clip_batch(clips, 3, T, S, yuv420=yuv420)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert np.abs(got[0][1].astype(int) - want[0][1].astype(int)).max() <= (3 if yuv420 else 1)
    assert got[0][2].max() == 0 and not got[3][2]


def test_device_ring_windows_on_cpu():
    """Push/gather through the ring (CPU device): the windows hold the
    packed slots in order, and the padded window repeats the newest."""
    S, R, T = 32, 6, 4
    k = RingKernels(R=R, S=S, yuv420=False, device="cpu", batch_k=3)
    ring = DeviceRing(k, RingUploader("cpu"))
    rng = np.random.RandomState(3)
    crops = [rng.randint(0, 256, (S, S, 3), np.uint8) for _ in range(9)]
    for i, c in enumerate(crops[:2]):
        ring.push(c, np.array([i, 0, i + S, S], np.float32), np.zeros((5, 2), np.float32))
    dev, boxes, _, scale = ring.window_padded(T)
    assert torch.equal(dev[0], torch.from_numpy(crops[0]))
    assert all(torch.equal(dev[j], torch.from_numpy(crops[1])) for j in (1, 2, 3))
    assert list(boxes[:, 0]) == [0, 1, 1, 1] and (scale == 1).all()
    for i, c in enumerate(crops[2:], start=2):         # wraps the ring
        ring.push(c, np.array([i, 0, i + S, S], np.float32), np.zeros((5, 2), np.float32))
    dev, boxes, _, _ = ring.window(T)
    for j in range(T):
        assert torch.equal(dev[j], torch.from_numpy(crops[9 - T + j]))
    assert list(boxes[:, 0]) == list(range(9 - T, 9))
