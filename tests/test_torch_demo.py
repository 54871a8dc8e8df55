"""The port's offline demo pipeline (``stdd_torch/eval/demo.py``) against the
JAX package's ``stdd_tpu/eval/demo.py``.

- ``window_index_lists`` over T = 1…40 (the reference's left-pad quirk
  included): exact.
- A synthetic detection cache through ``torch.save`` and each side's
  ``load_reference_cache``, then ``build_tracks`` / ``build_clips``, on a
  video the greedy tracker follows whole and on one it must segment
  (``find_longest``): exact.
- ``eval_video`` on the same frames, detections and weights (float32, clip
  8, crop 64), packed and ``dense=True``, with a long track and a short
  (reflect-padded) one: probs within 1e-4 of JAX's (the JAX scorer on its
  exact gather warp, the port's on K1's plain version).
- ``main`` on the CPU over ``.y4m`` videos with a trainer checkpoint.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.eval import demo as jax_demo
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_torch.config import I3DConfig
from stdd_torch.eval import demo
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.utils.checkpoint import save_checkpoint
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph
from stdd_torch.utils.video_io import write_y4m

from torch_port_helpers import port_i3d_variables

CFG = dict(num_frames=8, crop_size=64)
P_TOL = 1e-4


@pytest.mark.parametrize("clip_size", [8, 32])
def test_window_index_lists_match_jax(clip_size):
    for T in range(1, 41):
        got = demo.window_index_lists(T, clip_size)
        assert got == jax_demo.window_index_lists(T, clip_size), T
        assert all(len(w) == clip_size for w in got)


def synthetic_cache(rng, n_frames, n_faces, drop=lambda f, k: False):
    """(detections, lm68s) per frame: faces moving on straight paths with
    five landmarks on the template and 68 points around them; ``drop(f, k)``
    leaves face ``k`` out of frame ``f``."""
    dets, lm68s = [], []
    for f in range(n_frames):
        faces, lms = [], []
        for k in range(n_faces):
            if drop(f, k):
                continue
            x, y = 20 + 140 * k + 1.5 * f + rng.randn() * 0.5, 30 + 0.5 * f
            box = np.array([x, y, x + 70, y + 80], np.float64)
            lm5 = STD_POINTS_256 * (60 / 256.0) + box[:2] + 5
            faces.append((box, lm5.astype(np.float64), 0.95))
            lms.append(rng.uniform(0, 60, (68, 2)) + box[:2])
        dets.append(faces)
        lm68s.append(lms)
    return dets, lm68s


def _frames(rng, n, hw=(240, 360)):
    return [rng.randint(0, 255, hw + (3,), np.uint8) for _ in range(n)]


def _assert_same_tracks(got, want):
    assert len(got) == len(want) > 0
    for (ge, gs), (we, ws) in zip(got, want):
        assert gs == ws and len(ge) == len(we)
        for a, b in zip(ge, we):
            assert sorted(a) == sorted(b) and a["frame_idx"] == b["frame_idx"]
            for k in ("crop", "big_box", "lm5", "lm68"):
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("case", ["whole", "segmented"])
def test_cache_tracks_and_clips_match_jax(tmp_path, case):
    rng = np.random.RandomState(0)
    n = 20
    # segmented: no face on frame 0 (no track runs the whole video), and
    # face 1 missing from frame 12
    drop = (lambda f, k: f == 0 or (k, f) == (1, 12)) if case == "segmented" else \
        (lambda f, k: False)
    det, lm68 = synthetic_cache(rng, n, 2, drop)
    path = str(tmp_path / "video.mp4_32_yunet_320.pth")
    torch.save((det, lm68, {"fps": 30}), path)
    got, want = demo.load_reference_cache(path), jax_demo.load_reference_cache(path)
    for g, w in zip(got, want):
        assert len(g) == len(w) == n
    frames = _frames(rng, n)
    for clip_size in (8, 16):
        tracks = demo.build_tracks(*got, frames, clip_size)
        _assert_same_tracks(tracks, jax_demo.build_tracks(*want, frames, clip_size))
        clips = demo.build_clips(*got, frames, clip_size)
        jclips = jax_demo.build_clips(*want, frames, clip_size)
        assert [[e["frame_idx"] for e in c] for c in clips] == \
            [[e["frame_idx"] for e in c] for c in jclips]
    if case == "segmented":
        # find_longest split the video; no track starts on the empty frame 0
        assert len(tracks) >= 2 and tracks[0][0][0]["frame_idx"] > 0


@pytest.fixture(scope="module")
def scorers():
    variables = port_i3d_variables(I3DConfig(**CFG), seed=0)
    return (ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                           device="cpu"),
            JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                          use_pallas_warp=False))


@pytest.fixture(scope="module")
def eval_runs(scorers):
    """Both sides' eval_video on a 20-frame video (one track, 13 windows)
    and a 5-frame one (one reflect-padded window), packed and dense."""
    ts, js = scorers
    rng = np.random.RandomState(1)
    out = {}
    for name, n in (("long", 20), ("short", 5)):
        det, lm68 = synthetic_cache(rng, n, 1)
        frames = _frames(rng, n)
        for dense in (False, True):
            kw = dict(detect_res=det, lm68s=lm68, clip_size=8, crop_buffer=128, batch=4,
                      dense=dense)
            out[name, dense] = (demo.eval_video(ts, frames, **kw),
                                jax_demo.eval_video(js, frames, **kw))
    return out


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("video", ["long", "short"])
def test_eval_video_matches_jax(eval_runs, video, dense):
    got, want = eval_runs[video, dense]
    assert got["clips"] == want["clips"] == {"long": 13, "short": 1}[video]
    assert got["frames"] == want["frames"]
    assert np.all((np.array(got["preds"]) > 0) & (np.array(got["preds"]) < 1))
    assert np.abs(np.subtract(got["preds"], want["preds"])).max() <= P_TOL
    assert abs(got["video_score"] - want["video_score"]) <= P_TOL
    assert got["pred_label"] == want["pred_label"]


def test_eval_video_dense_matches_packed(scorers):
    """With no crop downscaled into the buffer, the dense and the packed
    path hand the scorer the same bytes. (Downscaled, the packed path takes
    one scale per clip and the dense path one per track, so their pixels
    differ by design: 5.3e-4 in prob here at crop_buffer 128, as in JAX's
    own dense-vs-packed test, ``tests/test_demo_path.py:150``, atol 2e-3.)"""
    ts, _ = scorers
    rng = np.random.RandomState(1)
    det, lm68 = synthetic_cache(rng, 20, 1)
    frames = _frames(rng, 20)
    kw = dict(detect_res=det, lm68s=lm68, clip_size=8, crop_buffer=160, batch=4)
    got = demo.eval_video(ts, frames, dense=True, **kw)
    want = demo.eval_video(ts, frames, **kw)
    assert got["clips"] == want["clips"] == 13
    assert np.abs(np.subtract(got["preds"], want["preds"])).max() <= 1e-6


def test_yunet_demo_detector_layout():
    """Cache-layout rows from YuNet rows, with the placeholder 68 points."""
    lm = (STD_POINTS_256 * 0.2 + 40).reshape(-1)
    rows = np.asarray([[10, 20, 50, 60, *lm, 0.9]], np.float32)
    seen = []

    class Det:
        input_size = (320, 320)

    def fake_scaled(det, frame_bgr, det_size=None):
        seen.append(frame_bgr[0, 0].tolist())
        return rows

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("stdd_torch.models.yunet.detect_scaled", fake_scaled)
        frame = np.zeros((64, 64, 3), np.uint8)
        frame[0, 0] = (1, 2, 3)                       # RGB in, BGR to the detector
        det, lm68 = demo.yunet_demo_detector(Det())([frame])
    assert seen == [[3, 2, 1]]
    (box, lm5, score), = det[0]
    np.testing.assert_array_equal(box, [10, 20, 60, 80])
    np.testing.assert_array_equal(lm5, rows[0, 4:14].reshape(5, 2))
    assert score == pytest.approx(0.9)
    np.testing.assert_array_equal(lm68[0][0], np.tile(lm5.mean(0), (68, 1)))


def test_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``main`` over two ``.y4m`` videos with a trainer checkpoint whose
    sidecar sets crop 64; the detector is replaced by the fixed cache
    rows (the YuNet-shaped random graph finds no real faces), so the whole
    CLI runs: tracking, packed scoring on the CPU, the CSVs."""
    rng = np.random.RandomState(2)
    for sub in ("real", "fake"):
        os.makedirs(tmp_path / "v" / sub)
        write_y4m(str(tmp_path / "v" / sub / "a.y4m"), _frames(rng, 12, (240, 320)))
    variables = port_i3d_variables(I3DConfig(**CFG), seed=0)
    ckpt = save_checkpoint(str(tmp_path / "ck"), "i3d", 1, variables,
                           metadata={"clip_size": 8, "crop_size": 64, "temporal_only": False})
    det, lm68 = synthetic_cache(np.random.RandomState(3), 10, 1)    # --max_frame 10
    monkeypatch.setattr(demo, "yunet_demo_detector", lambda yunet: lambda frames: (det, lm68))
    demo.main(["--video_root", str(tmp_path / "v"), "--out_dir", str(tmp_path / "out"),
               "--jax_ckpt", ckpt, "--clip_size", "8", "--max_frame", "10", "--device", "cpu",
               "--yunet_model", write_onnx(yunet_shaped_graph(0), str(tmp_path / "y.onnx"))])
    rows = list(csv.DictReader(open(tmp_path / "out" / "per_video.csv")))
    assert sorted(r["gt_label"] for r in rows) == ["0", "1"]
    assert all(r["frames_processed"] == "10" and 0 < float(r["video_score"]) < 1 for r in rows)
    assert os.path.exists(tmp_path / "out" / "summary.csv")
    assert "Summary:" in capsys.readouterr().out


def test_main_checks_every_container_before_scoring(tmp_path, monkeypatch):
    """A tree that mixes ``.y4m`` and ``.mp4`` fails before the scorer is
    loaded, naming every file it cannot decode."""
    import stdd_torch.runtime.classifier as classifier

    for rel in ("real/a.y4m", "real/b.mp4", "fake/c.y4m", "fake/d.mp4"):
        (tmp_path / rel).parent.mkdir(exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    loaded = []
    monkeypatch.setattr(classifier, "load_scorer", lambda *a, **k: loaded.append(a))
    with pytest.raises(ValueError, match="ROADMAP.md §1 item 2") as err:
        demo.main(["--video_root", str(tmp_path), "--device", "cpu",
                   "--out_dir", str(tmp_path / "out")])
    assert "b.mp4" in str(err.value) and "d.mp4" in str(err.value)
    assert loaded == [] and not os.path.exists(tmp_path / "out")


def test_main_accepts_the_jax_cache_dir_and_ignores_it(tmp_path, monkeypatch):
    """A JAX demo command line with ``--cache_dir`` (parsed and never read
    by ``stdd_tpu/eval/demo.py``) parses: the run goes on to the container
    check, and the cache directory is not made."""
    import stdd_torch.runtime.classifier as classifier

    (tmp_path / "real").mkdir()
    (tmp_path / "real" / "a.mp4").write_bytes(b"")
    monkeypatch.setattr(classifier, "load_scorer", lambda *a, **k: None)
    with pytest.raises(ValueError, match="a.mp4"):
        demo.main(["--video_root", str(tmp_path), "--cache_dir", str(tmp_path / "cache"),
                   "--max_frame", "10", "--device", "cpu", "--out_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "cache")


def test_main_refuses_int8_and_a_missing_card(monkeypatch):
    """``--int8`` is served now (``test_torch_int8.py``); a missing card is
    still refused, with ``--int8`` too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        demo.main(["--video_root", ".", "--int8"])
    with pytest.raises(SystemExit, match="--device cpu"):
        demo.main(["--video_root", "."])
