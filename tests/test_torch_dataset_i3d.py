"""The port's I3D clip dataset, degradations and splits (``stdd_torch/data``)
against the JAX package's (``stdd_tpu/data``), on a clip tree the test
writes: real and fake videos, tracks of overlapping 8-frame clips (with and
without ``frame_ids.npy``), 40×48 frames.

Both datasets draw from a ``np.random.RandomState`` of the same seed, so
every crop start, jitter factor, noise field, blur size, JPEG quality and
erase box must come out the same, and the generators must end in the same
state. The port's blur and JPEG are integer re-implementations of OpenCV's
(``stdd_torch/data/degrade.py``); both are bit-equal to cv2 here, which is
stricter than the bound of one grey level the port promises.
"""

import os

import cv2
import numpy as np
import pytest

from stdd_tpu.data import dataset_i3d as jax_ds
from stdd_tpu.data.splits import make_split as jax_make_split
from stdd_tpu.train.run_i3d import ensure_val_floor as jax_ensure_val_floor
from stdd_torch.data import dataset_i3d as port_ds
from stdd_torch.data.degrade import gaussian_blur, jpeg_recompress
from stdd_torch.data.splits import make_split
from stdd_torch.train.run_i3d import ensure_val_floor

H, W, CLIP = 40, 48, 8
# technique/video: (tracks, clips per track); each fake names the original it
# was made from, so the splits link three identity groups
VIDEOS = {
    "original/000": (2, 4), "original/001": (1, 5), "original/002": (1, 1),
    "deepfakes/000_003": (1, 4), "deepfakes/001_004": (2, 3), "face2face/002_005": (1, 6),
}


def write_tree(root, with_frame_ids=True):
    rng = np.random.RandomState(0)
    for vid, (tracks, clips) in VIDEOS.items():
        for t in range(tracks):
            base = rng.randint(40, 200, (1, H, W, 3))
            frames = np.clip(base + rng.randint(-30, 30, (CLIP + 4 * clips, H, W, 3)), 0, 255)
            for c in range(clips):
                d = os.path.join(root, vid, f"track_{t}", f"clip_{c}")
                os.makedirs(d)
                np.save(os.path.join(d, "images.npy"), frames[4 * c: 4 * c + CLIP].astype(np.uint8))
                if with_frame_ids and not vid.startswith("face2face"):
                    np.save(os.path.join(d, "frame_ids.npy"), np.arange(4 * c, 4 * c + CLIP))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("clips")))


def both(tree, **kw):
    return jax_ds.I3DClipDataset(root_dir=tree, **kw), port_ds.I3DClipDataset(root_dir=tree, **kw)


def test_windows_labels_and_plain_clips_match_jax(tree):
    assert port_ds.CLIP_STEP == 4
    for T in (8, 16, 32):
        j, p = both(tree, T=T)
        assert p.windows == j.windows and p.labels == j.labels
        assert p.tech_names == j.tech_names and p.track_keys == j.track_keys
        for i in range(len(j)):
            a, b = j[i], p[i]
            assert b["clip"].dtype == np.uint8 and np.array_equal(b["clip"], a["clip"])
            assert b["y"] == a["y"]
    assert set(p.labels) == {0, 1}


def test_training_draws_without_augmentation_match_jax(tree):
    """Crop starts and the shuffled batch order, augmentations off."""
    off = dict(color_jitter=0.0, p_gauss_blur=0.0, p_gauss_noise=0.0, p_jpeg=0.0, p_erase=0.0)
    j, p = both(tree, T=12, is_train=True, seed=3, **off)
    for (ca, ya), (cb, yb) in zip(j.batches(4, seed=5), p.batches(4, seed=5)):
        assert np.array_equal(ca, cb) and np.array_equal(ya, yb) and yb.dtype == np.float32
    assert len(list(p.batches(4, seed=5))) == len(p) // 4
    one = port_ds.I3DClipDataset(clip_dirs=p.windows[0], T=12)
    assert len(list(one.batches(4))) == 1                       # smaller than a batch: whole


@pytest.mark.parametrize("aug", ["color_jitter", "p_gauss_noise", "p_gauss_blur", "p_jpeg",
                                 "p_erase", "all"])
def test_each_augmentation_forced_on_matches_jax(tree, aug):
    off = dict(color_jitter=0.0, p_gauss_blur=0.0, p_gauss_noise=0.0, p_jpeg=0.0, p_erase=0.0)
    on = {k: (0.4 if k == "color_jitter" else 1.0) for k in off}
    kw = on if aug == "all" else dict(off, **{aug: on[aug]})
    j, p = both(tree, T=16, is_train=True, seed=11, **kw)
    for i in range(len(j)):
        a, b = j[i]["clip"], p[i]["clip"]
        assert np.array_equal(a, b), (aug, i, np.abs(a.astype(int) - b).max())
    sj, sp = j.rng.get_state(), p.rng.get_state()
    assert np.array_equal(sj[1], sp[1]) and sj[2:] == sp[2:]     # the same draws, in order


def test_geo_jitter_is_refused_by_name(tree):
    with pytest.raises(ValueError, match="ROADMAP"):
        port_ds.I3DClipDataset(root_dir=tree, geo_jitter=0.5)


def natural_image(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 60 * np.sin(xx / 17.0 + c) * np.cos(yy / 23.0 - c) for c in range(3)],
                    -1)
    return np.clip(base + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [60, 95])
def test_jpeg_round_trip_matches_cv2(quality):
    """Mean |Δ| ≤ 1 grey level is the bound; measured 0 (bit-equal) on every
    image here, odd sizes and a clip of frames included."""
    imgs = [natural_image(224, 224, 1), natural_image(37, 41, 2),
            np.random.RandomState(3).randint(0, 256, (64, 80, 3), np.uint8)]
    for img in imgs:
        ok, enc = cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        want = cv2.imdecode(enc, cv2.IMREAD_COLOR)
        d = np.abs(jpeg_recompress(img, quality).astype(int) - want)
        assert d.mean() <= 1.0 and d.max() == 0, (img.shape, d.mean(), d.max())
    clip = np.stack([natural_image(48, 64, s) for s in range(4)])
    want = np.stack([cv2.imdecode(cv2.imencode(".jpg", f, [int(cv2.IMWRITE_JPEG_QUALITY),
                                                           quality])[1], cv2.IMREAD_COLOR)
                     for f in clip])
    assert np.array_equal(jpeg_recompress(clip, quality), want)


@pytest.mark.parametrize("k", [3, 5])
def test_gaussian_blur_matches_cv2(k):
    clip = np.stack([natural_image(37, 41, s) for s in range(3)])
    want = np.stack([cv2.GaussianBlur(f, (k, k), 0) for f in clip])
    assert np.abs(gaussian_blur(clip, k).astype(int) - want).max() <= 1
    assert np.array_equal(gaussian_blur(clip, k), want)


def test_make_split_and_val_floor_match_jax(tree):
    import glob

    dirs = sorted(glob.glob(os.path.join(tree, "**", "track_*", "clip_*"), recursive=True))
    for ratios, seed in (((0.7, 0.15, 0.15), 42), ((0.5, 0.5, 0.0), 1), ((0.9, 0.1, 0.0), 0)):
        assert make_split(dirs, ratios, seed) == jax_make_split(dirs, ratios, seed)
    for val_ratio in (0.1, 0.0):
        split = make_split(dirs, (1 - val_ratio, val_ratio, 0.0), seed=0)
        want = jax_ensure_val_floor({k: list(v) for k, v in split.items()}, val_ratio)
        got = ensure_val_floor(split, val_ratio)
        assert got == want and bool(got["val"]) == (val_ratio > 0)
    one_video = [d for d in dirs if "/original/000/" in d]
    for floor in (ensure_val_floor, jax_ensure_val_floor):
        with pytest.raises(SystemExit):
            floor({"train": list(one_video), "val": [], "test": []}, 0.1)
