"""The port's dataset-production pipeline against the JAX package
(``stdd_torch/data/preprocess.py`` vs ``stdd_tpu/data/preprocess.py``).

The cases of ``tests/test_preprocess.py`` run on ``.y4m`` videos, then both
pipelines run on the same decoded frames (the JAX one reads them through a
stand-in for ``cv2.VideoCapture``) with the same detector, AU model and
landmarker:
- under the fake models of ``tests/test_preprocess.py`` and a crop size
  equal to the detector's box (no resize on either side), the two trees
  are equal file for file: every ``.npy`` (images, landmarks, AU dicts,
  frame ids) and every ``master_clip_log.csv`` row; at the default 224
  crop the images differ by at most one grey level (the port's resize is
  cv2's INTER_LINEAR grid in float32) and the rest stays equal;
- on a rendered scene (``eval/bench_scene.py``) with the packaged
  landmarker and bridged random AU weights: the same tracks, clips and
  frame ids; images ≤ 1 grey level; dense landmarks ≤ 0.5 px; AU dicts
  equal on ≥ 95% of the entries (an activation near 0.5 may flip with a
  one-grey-level input change).
"""

import csv
import os

import numpy as np
import pytest

from stdd_tpu.data import preprocess as jpre
from stdd_torch.data import preprocess as tpre
from stdd_torch.data.features import process_clip_tree
from stdd_torch.ops.align import STD_POINTS_256, find_similarity_np
from stdd_torch.utils.video_io import read_y4m, write_y4m

from test_preprocess import _FakeAU, _fake_detect, _fake_landmarker

cv2 = pytest.importorskip("cv2", reason="the JAX pipeline reads video through cv2")


def _write_video(path, n_frames=24, size=(320, 240), seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (size[1], size[0], 3), np.uint8)
    write_y4m(path, [base] * n_frames)


def test_pipeline_writes_clips(tmp_path):
    _write_video(str(tmp_path / "vids" / "real" / "a.y4m"))
    pipe = tpre.PreprocessPipeline(_fake_detect, au_extractor=_FakeAU(),
                                   landmarker=_fake_landmarker, clip_length=8, clip_step=4)
    logs = tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out"))
    assert len(logs) == 1 and logs[0]["clips"] == 5 and logs[0]["frames"] == 24
    clip0 = tmp_path / "out" / "real" / "a" / "track_1" / "clip_00000"
    imgs = np.load(clip0 / "images.npy")
    assert imgs.shape == (8, 224, 224, 3) and imgs.dtype == np.uint8
    lms = np.load(clip0 / "landmarks.npy", allow_pickle=True)
    assert len(lms) == 8 and lms[0].shape == (478, 2)
    aus = np.load(clip0 / "aus.npy", allow_pickle=True)
    assert len(aus) == 8 and isinstance(aus[0], dict)
    np.testing.assert_array_equal(np.load(clip0 / "frame_ids.npy"), np.arange(8))
    assert (tmp_path / "out" / "master_clip_log.csv").exists()
    assert (tmp_path / "out" / "pipeline_performance_log.csv").exists()


def test_resume_skip_and_max_frames(tmp_path):
    _write_video(str(tmp_path / "vids" / "real" / "a.y4m"))
    pipe = tpre.PreprocessPipeline(_fake_detect, au_extractor=_FakeAU())
    logs = tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out"), max_frames=12)
    assert logs[0]["frames"] == 12 and logs[0]["clips"] == 2
    assert tpre.already_processed(str(tmp_path / "out"), "real/a")
    assert tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out")) == []


def test_full_chain_to_dataset(tmp_path):
    """videos → clips → features → DualFeaturesClipDataset, in the port."""
    from stdd_torch.data.dataset import DualFeaturesClipDataset

    _write_video(str(tmp_path / "vids" / "original" / "v0.y4m"), seed=1)
    _write_video(str(tmp_path / "vids" / "deepfakes" / "v1.y4m"), seed=2)
    pipe = tpre.PreprocessPipeline(_fake_detect, au_extractor=_FakeAU(),
                                   landmarker=_fake_landmarker)
    tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out"))
    stats = process_clip_tree(str(tmp_path / "out"))
    assert stats["lmk_ok"] > 0 and stats["au_ok"] > 0
    ds = DualFeaturesClipDataset(root_dir=str(tmp_path / "out"), T=8)
    assert len(ds) == 10 and set(ds.labels) == {0, 1}
    item = ds[0]
    assert item["A"].shape == (8, 36) and item["L"].shape == (8, 132)


def test_au_last_known_fill(tmp_path):
    _write_video(str(tmp_path / "vids" / "real" / "a.y4m"), n_frames=10)
    calls = {"n": 0}

    class CountingAU(_FakeAU):
        def __call__(self, faces):
            calls["n"] += 1
            return super().__call__(faces)

    pipe = tpre.PreprocessPipeline(_fake_detect, au_extractor=CountingAU(), au_every=2)
    tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out"))
    assert calls["n"] == 5
    aus = np.load(tmp_path / "out" / "real" / "a" / "track_1" / "clip_00000" / "aus.npy",
                  allow_pickle=True)
    assert all(a is not None for a in aus)


def test_clip_frame_span_respects_detection_gaps(tmp_path):
    gap_frames = {3, 4}

    def detect(frame_bgr):
        fid = int(frame_bgr[0, 0, 0]) - 1
        if fid in gap_frames:
            return np.empty((0, 15))
        return np.array([[8.0, 8.0, 40.0, 40.0] + [20.0] * 10 + [0.9]])

    frames = [np.full((64, 64, 3), i + 1, np.uint8) for i in range(12)]
    pipe = tpre.PreprocessPipeline(detect, clip_length=8, clip_step=4)
    w = tpre.ClipWriter(str(tmp_path))
    spans = []
    orig_submit = w.submit
    w.submit = lambda t: (spans.append((t.frame_start, t.frame_end)), orig_submit(t))[1]
    pipe.process_frames(iter(frames), w, "v")
    w.close()
    assert spans and spans[0] == (0, 9)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_lm_sentinel_passes_a_good_landmarker_and_flags_a_bad_one(tmp_path):
    _write_video(str(tmp_path / "vids" / "a.y4m"))
    pipe = tpre.PreprocessPipeline(_fake_detect, landmarker=_fake_landmarker,
                                   clip_length=8, clip_step=4)
    logs = tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out"))
    rows = _rows(tmp_path / "out" / "master_clip_log.csv")
    assert logs[0]["clips"] == 5 and len(rows) == 5 and not pipe._lm_flagged
    assert all(float(r["lm5_agreement"]) < 0.02 and r["lm_flagged"] == "False" for r in rows)

    def bad_landmarker(frame_rgb, tlbr):
        return _fake_landmarker(frame_rgb, tlbr) + 0.5 * 60.0

    pipe = tpre.PreprocessPipeline(_fake_detect, landmarker=bad_landmarker,
                                   clip_length=8, clip_step=4)
    logs = tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "bad"))
    assert pipe._lm_flagged == {1} and logs[0]["clips"] == 5
    rows = _rows(tmp_path / "bad" / "master_clip_log.csv")
    assert len(rows) == 5 and all(r["lm_flagged"] == "True" for r in rows)
    clip0 = tmp_path / "bad" / "a" / "track_1" / "clip_00000"
    assert all(l is None for l in np.load(clip0 / "landmarks.npy", allow_pickle=True))
    assert process_clip_tree(str(tmp_path / "bad"))["lmk_ok"] == 0
    pipe = tpre.PreprocessPipeline(_fake_detect, landmarker=bad_landmarker,
                                   clip_length=8, clip_step=4, lm_sentinel=False)
    assert tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "off"))[0]["clips"] == 5
    assert not pipe._lm_flagged


def test_aligned_mode_writes_serving_geometry_clips(tmp_path):
    from stdd_torch.runtime.engine import get_crop_box

    def detect(frame_bgr):
        lm = (STD_POINTS_256 * (44.0 / 256.0) + np.array([10.0, 9.0])).reshape(-1)
        return np.asarray([[8.0, 8.0, 48.0, 48.0, *lm, 0.9]], np.float32)

    _write_video(str(tmp_path / "vids" / "a.y4m"))
    pipe = tpre.PreprocessPipeline(detect, clip_length=8, clip_step=4, crop_size=(64, 64),
                                   aligned=True)
    logs = tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out"))
    assert logs[0]["clips"] == 5
    imgs = np.load(tmp_path / "out" / "a" / "track_1" / "clip_00000" / "images.npy")
    assert imgs.shape == (8, 64, 64, 3) and imgs.dtype == np.uint8
    lm5 = STD_POINTS_256 * (44.0 / 256.0) + np.array([10.0, 9.0])
    big = get_crop_box((240, 320), np.array([8.0, 8.0, 48.0, 48.0]), 0.5)
    pts = np.tile(lm5 - big[:2], (8, 1)).astype(np.float32)
    tpl = np.tile(STD_POINTS_256 * (64 / 256.0), (8, 1)).astype(np.float32)
    p = np.concatenate([pts, np.ones((40, 1), np.float32)], axis=1) @ find_similarity_np(pts, tpl)
    np.testing.assert_allclose(p[:, :2], tpl, atol=0.5)


def test_other_containers_are_refused_by_name(tmp_path):
    os.makedirs(tmp_path / "vids")
    (tmp_path / "vids" / "clip.mp4").write_bytes(b"\x00" * 64)
    pipe = tpre.PreprocessPipeline(_fake_detect)
    with pytest.raises(ValueError, match=r"clip\.mp4.*no decoder"):
        tpre.process_tree(pipe, str(tmp_path / "vids"), str(tmp_path / "out"))


# -- both pipelines on the same frames ----------------------------------------------

def _jax_tree(monkeypatch, pipe, video_root, out_dir):
    """Run the JAX pipeline over the ``.y4m`` tree, its cv2.VideoCapture
    replaced by a reader yielding the port's decoded frames."""

    class Cap:
        def __init__(self, path):
            self.frames = read_y4m(path)

        def read(self):
            f = next(self.frames, None)
            return (f is not None), f

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoCapture", Cap)
    return jpre.process_tree(pipe, video_root, out_dir, exts=(".y4m",))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            rel = os.path.relpath(os.path.join(d, fn), root)
            if fn.endswith(".npy"):
                out[rel] = np.load(os.path.join(d, fn), allow_pickle=True)
    rows = _rows(os.path.join(root, "master_clip_log.csv"))
    for r in rows:
        r["path"] = os.path.relpath(r["path"], root)
    return out, rows


def _assert_same_objects(a, b, rel, atol=0.0):
    assert a.dtype == b.dtype and a.shape == b.shape, rel
    if a.dtype != object:
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=rel)
        return
    for x, y in zip(a.ravel(), b.ravel()):
        if isinstance(x, dict):
            assert x == y, rel
        elif x is None:
            assert y is None, rel
        else:
            np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                       atol=atol, rtol=0, err_msg=rel)


@pytest.mark.parametrize("crop", ["box_size", "default_224"])
def test_trees_match_jax_file_for_file_under_fake_models(tmp_path, monkeypatch, crop):
    _write_video(str(tmp_path / "vids" / "original" / "v0.y4m"), seed=1)
    _write_video(str(tmp_path / "vids" / "deepfakes" / "v1.y4m"), n_frames=18, seed=2)
    # _fake_detect's box is 60 × 70 at (40, 30): at that crop size neither
    # package resizes
    kw = dict(au_extractor=_FakeAU(), landmarker=_fake_landmarker, clip_length=8, clip_step=4)
    if crop == "box_size":
        kw["crop_size"] = (60, 70)
    jlogs = _jax_tree(monkeypatch, jpre.PreprocessPipeline(_fake_detect, **kw),
                      str(tmp_path / "vids"), str(tmp_path / "jax"))
    tlogs = tpre.process_tree(tpre.PreprocessPipeline(_fake_detect, **kw),
                              str(tmp_path / "vids"), str(tmp_path / "port"))
    assert [(l["video"], l["frames"], l["clips"]) for l in tlogs] == \
        [(l["video"], l["frames"], l["clips"]) for l in jlogs] == \
        [("deepfakes/v1", 18, 3), ("original/v0", 24, 5)]
    jt, jrows = _tree(str(tmp_path / "jax"))
    tt, trows = _tree(str(tmp_path / "port"))
    assert sorted(tt) == sorted(jt) and len(tt) == 8 * 4
    assert trows == jrows
    for rel in jt:
        grey = 1 if crop == "default_224" and rel.endswith("images.npy") else 0
        _assert_same_objects(tt[rel], jt[rel], rel, atol=grey)


def test_rendered_scene_matches_jax_with_real_models(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from stdd_tpu.models.au_resnet import AUExtractor as JAU, AUResNet18 as JNet
    from stdd_tpu.models.facemesh import DenseLandmarker as JLM
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.models.au_resnet import AUExtractor as TAU
    from stdd_torch.models.facemesh import DenseLandmarker as TLM

    scene = BenchScene((240, 320), n_faces=2, seed=0, face_px=96, device="cpu")
    n = 12
    frames = [scene.frame(i, copy=True) for i in range(n)]
    rows = {f.tobytes(): scene.oracle(i) for i, f in enumerate(frames)}
    os.makedirs(tmp_path / "vids")
    write_y4m(str(tmp_path / "vids" / "s.y4m"), frames)
    decoded = list(read_y4m(str(tmp_path / "vids" / "s.y4m")))
    by_index = {f.tobytes(): rows[frames[i].tobytes()] for i, f in enumerate(decoded)}

    def detect(frame_bgr):
        return by_index[np.ascontiguousarray(frame_bgr).tobytes()]

    v = jax.tree_util.tree_map(np.asarray, jax.jit(JNet().init)(jax.random.PRNGKey(0),
                                                                jnp.zeros((1, 32, 32, 3))))
    kw = dict(clip_length=8, clip_step=4, track_kwargs=dict(
        track_thresh=0.5, match_thresh=0.8, track_buffer=30, split_low_scores=False))
    jpipe = jpre.PreprocessPipeline(detect, au_extractor=JAU(jax.tree_util.tree_map(jnp.asarray, v)),
                                    landmarker=JLM.pretrained(), **kw)
    tpipe = tpre.PreprocessPipeline(detect, au_extractor=TAU(v, device="cpu"),
                                    landmarker=TLM.pretrained(device="cpu"), **kw)
    jlogs = _jax_tree(monkeypatch, jpipe, str(tmp_path / "vids"), str(tmp_path / "jax"))
    tlogs = tpre.process_tree(tpipe, str(tmp_path / "vids"), str(tmp_path / "port"))
    assert jlogs[0]["clips"] == tlogs[0]["clips"] == 4      # 2 tracks × clips ending at 8, 12
    jt, jrows = _tree(str(tmp_path / "jax"))
    tt, trows = _tree(str(tmp_path / "port"))
    assert sorted(tt) == sorted(jt)
    key = ("video", "track_id", "clip_idx", "frame_start", "frame_end", "n_frames", "path",
           "lm_flagged")
    assert [[r[k] for k in key] for r in trows] == [[r[k] for k in key] for r in jrows]
    au_same = au_all = 0
    for rel in jt:
        if rel.endswith("images.npy"):
            _assert_same_objects(tt[rel], jt[rel], rel, atol=1)
        elif rel.endswith("landmarks.npy"):
            _assert_same_objects(tt[rel], jt[rel], rel, atol=0.5)
        elif rel.endswith("frame_ids.npy"):
            np.testing.assert_array_equal(tt[rel], jt[rel])
        else:
            for a, b in zip(tt[rel].ravel(), jt[rel].ravel()):
                au_same += sum(a[k] == b[k] for k in a)
                au_all += len(a)
    assert au_all and au_same / au_all >= 0.95, au_same / au_all


def test_cli_runs_on_the_cpu_and_refuses_what_it_lacks(tmp_path, capsys):
    from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph

    _write_video(str(tmp_path / "vids" / "a.y4m"), n_frames=6, seed=3)
    model = write_onnx(yunet_shaped_graph(0), str(tmp_path / "yunet.onnx"))
    logs = tpre.main(["--video_root", str(tmp_path / "vids"), "--out_dir", str(tmp_path / "out"),
                      "--yunet_model", model, "--landmarker", "none", "--device", "cpu"])
    assert len(logs) == 1 and logs[0]["frames"] == 6
    assert "processed 1 videos" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="nowhere.onnx"):
        tpre.main(["--video_root", str(tmp_path / "vids"), "--out_dir", str(tmp_path / "o2"),
                   "--yunet_model", str(tmp_path / "nowhere.onnx"), "--device", "cpu"])
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tpre.main(["--video_root", str(tmp_path / "vids"), "--out_dir", str(tmp_path / "o3"),
                       "--yunet_model", model])
