"""The port's annotator (``stdd_torch/eval/viz.py``) against the JAX
package's (``stdd_tpu/eval/viz.py``, whose cv2 drawing is the oracle).

``visualize_detections`` (with the JAX ``int32`` truncation of the rows,
the FPS label, boxes and landmarks partly off-frame), ``_track_color``,
``visualize_tracks`` and ``draw_dense_landmarks`` (a copy, and in place)
are bit-equal. The CLI runs on the CPU over a PNG and a ``.y4m``, the
detector being the YuNet-shaped random graph (no YuNet weights exist
here): its output equals the JAX drawing functions (and JAX's tracker) on
the rows the port's detector gives, frame by frame; other containers and a
missing card stop it by name."""

import numpy as np
import pytest
import torch

from stdd_tpu.eval import viz as jax_viz
from stdd_tpu.track.byte_tracker import ByteTracker as JaxByteTracker
from stdd_torch.config import DetectorConfig
from stdd_torch.eval import viz
from stdd_torch.eval.scene import Scene
from stdd_torch.models.facemesh import DenseLandmarker
from stdd_torch.models.yunet import YuNet, detect_scaled
from stdd_torch.utils.image_io import imread, imwrite
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph
from stdd_torch.utils.video_io import read_y4m, write_y4m


class _Track:
    def __init__(self, tid, tlbr):
        self.track_id, self.tlbr = tid, np.asarray(tlbr, np.float32)


def rows(rng, n, H, W):
    xy = rng.uniform(-20, [W, H], (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    lm = xy[:, None] + rng.uniform(-5, 1.0, (n, 5, 2)) * wh[:, None] * 0.3 + wh[:, None] / 2
    return np.concatenate([xy, wh, lm.reshape(n, 10), rng.uniform(0, 1, (n, 1))],
                          1).astype(np.float32)


def test_colors_and_detections_bit_equal_to_jax():
    assert viz.LANDMARK_COLORS == jax_viz.LANDMARK_COLORS
    assert all(viz._track_color(t) == jax_viz._track_color(t) for t in range(40))
    rng = np.random.RandomState(0)
    for i in range(6):
        img = rng.randint(0, 256, (90, 130, 3)).astype(np.uint8)
        r = rows(rng, i, 90, 130)
        fps = None if i % 2 else float(rng.uniform(1, 99))
        got, want = viz.visualize_detections(img, r, fps=fps), jax_viz.visualize_detections(
            img, r, fps=fps)
        np.testing.assert_array_equal(got, want)
        assert (img == viz.visualize_detections(img, r[:0])).all()   # the input is copied


def test_tracks_and_dense_landmarks_bit_equal_to_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (100, 140, 3)).astype(np.uint8)
    tracks = [_Track(1, (5.7, 8.2, 60.9, 70.1)), _Track(12, (-10, 50, 40, 120)),
              _Track(305, (100, -4, 150, 30))]
    for probs in (None, {1: 0.7345, 305: 0.05}):
        np.testing.assert_array_equal(viz.visualize_tracks(img, tracks, probs),
                                      jax_viz.visualize_tracks(img, tracks, probs))
    pts = rng.uniform(-3, [143, 103], (478, 2)).astype(np.float32)
    np.testing.assert_array_equal(viz.draw_dense_landmarks(img, pts),
                                  jax_viz.draw_dense_landmarks(img, pts))
    a, b = img.copy(), img.copy()
    assert viz.draw_dense_landmarks(a, pts, (1, 2, 3), copy=False) is a
    jax_viz.draw_dense_landmarks(b, pts, (1, 2, 3), copy=False)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def det_model(tmp_path_factory):
    return write_onnx(yunet_shaped_graph(0), str(tmp_path_factory.mktemp("det") / "y.onnx"))


def expected(frames, det_model, track, landmarks):
    """The JAX annotator's drawing on the port detector's rows."""
    det = YuNet(det_model, DetectorConfig(conf_threshold=0.6), device="cpu")
    lm = DenseLandmarker.pretrained(device="cpu") if landmarks else None
    tracker = JaxByteTracker(track_thresh=0.5, match_thresh=0.8, track_buffer=30,
                             split_low_scores=False) if track else None
    out = []
    for f in frames:
        r = detect_scaled(det, f, 64)
        if tracker is not None:
            tlbr = (np.stack([r[:, 0], r[:, 1], r[:, 0] + r[:, 2], r[:, 1] + r[:, 3], r[:, 14]],
                             axis=1) if r.size else np.zeros((0, 5), np.float32))
            o = jax_viz.visualize_tracks(f, tracker.update(tlbr))
        else:
            o = jax_viz.visualize_detections(f, r) if r.size else f.copy()
        if lm is not None:
            for row in r.reshape(-1, 15):
                pts = lm(f[:, :, ::-1], (row[0], row[1], row[0] + row[2], row[1] + row[3]))
                jax_viz.draw_dense_landmarks(o, pts, copy=False)
        out.append(o)
    return out


@pytest.mark.parametrize("kind,flags", [("png", []), ("png", ["--dense_landmarks"]),
                                        ("y4m", ["--track"])], ids=["png", "png_landmarks",
                                                                    "y4m_track"])
def test_cli_on_the_cpu_matches_the_jax_drawing(tmp_path, det_model, kind, flags, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = Scene((120, 160), n_faces=1, seed=0, face_px=60)
        frames = [scene.frame(i) for i in range(3 if kind == "y4m" else 1)]
        src, dst = str(tmp_path / f"in.{kind}"), str(tmp_path / f"out.{kind}")
        if kind == "png":
            imwrite(src, frames[0])
        else:
            write_y4m(src, frames, fps=25)
            frames = list(read_y4m(src))              # what the CLI reads
        assert viz.main(["--input", src, "--output", dst, "--det_model", det_model,
                         "--det_size", "64", "--device", "cpu"] + flags) == 0
        want = expected(frames, det_model, "--track" in flags, "--dense_landmarks" in flags)
    finally:
        torch.set_num_threads(n)
    if kind == "png":
        got = [imread(dst)]
        assert "annotated image" in capsys.readouterr().out
    else:
        got = list(read_y4m(dst))
        ref = str(tmp_path / "want.y4m")
        write_y4m(ref, want, fps=25)
        want = list(read_y4m(ref))                    # the .y4m round trip of the same overlays
        with open(dst, "rb") as f:
            assert f.readline().split()[3] == b"F25:1"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any((g != f).any() for g, f in zip(got, frames))          # something was drawn


def test_cli_refuses_other_containers_and_a_missing_card(tmp_path, monkeypatch):
    for argv in (["--input", "a.mp4", "--output", "b.mp4"],
                 ["--input", "a.png", "--output", "b.jpg"],
                 ["--input", "a.y4m", "--output", "b.png"]):
        with pytest.raises(SystemExit, match="ROADMAP.md §1 item 2|written as"):
            viz.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        viz.main(["--input", "a.png", "--output", "b.png"])
