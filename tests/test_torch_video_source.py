"""The port's video-file source and the app's ``--source PATH.y4m``
(``stdd_torch/runtime/sources.py::iter_video_file`` vs
``stdd_tpu/runtime/sources.py:22``).

JAX's source decodes through ``cv2.VideoCapture``, patched here (this test
only) to the port's reader, so the frames each yields must be equal: the
same count and pixels for ``loop`` and ``max_frames``. A file with no frame
raises in both, with and without ``loop``. ``main`` of the app takes a
``.y4m`` through its normal entry point (a run on the CPU, and the argument
check alone) and refuses other containers, webcams and a window naming
ROADMAP.md §1 item 2; ``--out_video PATH.y4m`` writes the overlay: the file
is byte-equal to the JAX overlay (cv2's drawing on the same frames)
written through the port's ``.y4m`` encoder.
"""

import numpy as np
import pytest
import torch

from stdd_tpu.runtime import sources as jax_sources
from stdd_torch.config import I3DConfig
from stdd_torch.eval.scene import Scene
from stdd_torch.runtime import app, classifier, sources
from stdd_torch.utils.checkpoint import save_checkpoint
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph
from stdd_torch.utils.video_io import read_y4m, write_y4m
from stdd_torch.utils.weights import i3d_torch_to_flax

from torch_port_helpers import install_y4m_capture


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # six test processes share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def video(tmp_path):
    path = str(tmp_path / "clip.y4m")
    rng = np.random.RandomState(0)
    write_y4m(path, [rng.randint(0, 256, (32, 48, 3)).astype(np.uint8) for _ in range(5)])
    return path


@pytest.mark.parametrize("loop,max_frames", [(False, None), (False, 3), (True, 12), (True, 5)])
def test_iter_video_file_matches_jax(video, monkeypatch, loop, max_frames):
    install_y4m_capture(monkeypatch)
    got = list(sources.iter_video_file(video, loop=loop, max_frames=max_frames))
    want = list(jax_sources.iter_video_file(video, loop=loop, max_frames=max_frames))
    assert len(got) == len(want) == (max_frames or 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_empty_file_raises_and_other_containers_are_refused(tmp_path, monkeypatch):
    empty = str(tmp_path / "empty.y4m")
    with open(empty, "wb") as f:
        f.write(b"YUV4MPEG2 W48 H32 F30:1 Ip A1:1 C420jpeg\n")
    install_y4m_capture(monkeypatch)
    for loop in (False, True):
        with pytest.raises(RuntimeError, match="no frames"):
            list(sources.iter_video_file(empty, loop=loop))
        with pytest.raises(RuntimeError, match="no frames"):
            list(jax_sources.iter_video_file(empty, loop=loop))
    with pytest.raises(ValueError, match=r"item 2") as e:
        next(sources.iter_video_file(str(tmp_path / "call.mp4")))
    assert "call.mp4" in str(e.value)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("source", ["clip.y4m", "CLIP.Y4M", "screen", "screen:Teams"])
def test_main_accepts_y4m_and_screen_sources(monkeypatch, source):
    """The argument check passes: ``main`` goes on to build the scorer."""
    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(classifier, "load_scorer", stop)
    with pytest.raises(_Stop):
        app.main(["--source", source, "--device", "cpu"])


@pytest.mark.parametrize("argv,word", [
    (["--source", "call.mp4"], "decoder"), (["--source", "call.avi"], "decoder"),
    (["--source", "webcam"], "webcams"), (["--source", "webcam:1"], "webcams"),
    (["--source", "clip.y4m", "--show"], "window"),
    (["--source", "clip.y4m", "--out_video", "o.avi"], "encoder"),
], ids=["mp4", "avi", "webcam", "webcam_1", "show", "out_video_avi"])
def test_main_refusals_name_item_2(argv, word):
    with pytest.raises(SystemExit, match=r"ROADMAP\.md §1 item 2") as e:
        app.main(argv + ["--device", "cpu"])
    assert word in str(e.value)


def test_main_scores_a_y4m_file_on_the_cpu(tmp_path, capsys):
    """``--source VIDEO.y4m`` end to end: the YuNet-shaped graph as
    ``--det_model``, a small checkpoint the port wrote, ``--max_frames``."""
    ts = classifier.ClipScorer.random_init(cfg=I3DConfig(num_frames=8, crop_size=64),
                                           device="cpu")
    ckpt = save_checkpoint(str(tmp_path), "i3d", 1, i3d_torch_to_flax(ts.model.state_dict()),
                           metadata={"crop_size": 64, "clip_size": 8, "temporal_only": False})
    det_model = write_onnx(yunet_shaped_graph(0), str(tmp_path / "yunet_shaped.onnx"))
    scene = Scene((240, 320), n_faces=1, seed=0, face_px=96)
    path = str(tmp_path / "scene.y4m")
    write_y4m(path, (scene.frame(i) for i in range(14)))
    app.main(["--source", path, "--device", "cpu", "--det_model", det_model,
              "--jax_ckpt", ckpt, "--clip_size", "8", "--stride", "4", "--detect_every", "2",
              "--max_frames", "10", "--no_warmup"])
    out = capsys.readouterr().out
    assert "frames: 10" in out and "meeting verdict: ready=False" in out


def test_main_out_video_writes_the_overlay(tmp_path, capsys):
    """``--out_video O.y4m``: every frame overlaid, at 30 fps. The random
    graph finds no face, so each overlay is the frame with the verdict
    label, drawn here by cv2 as the JAX app draws it."""
    import cv2

    ts = classifier.ClipScorer.random_init(cfg=I3DConfig(num_frames=8, crop_size=64),
                                           device="cpu")
    ckpt = save_checkpoint(str(tmp_path), "i3d", 1, i3d_torch_to_flax(ts.model.state_dict()),
                           metadata={"crop_size": 64, "clip_size": 8, "temporal_only": False})
    det_model = write_onnx(yunet_shaped_graph(0), str(tmp_path / "yunet_shaped.onnx"))
    scene = Scene((240, 320), n_faces=1, seed=1, face_px=96)
    path, out = str(tmp_path / "scene.y4m"), str(tmp_path / "overlay.y4m")
    write_y4m(path, (scene.frame(i) for i in range(6)))
    app.main(["--source", path, "--device", "cpu", "--det_model", det_model,
              "--jax_ckpt", ckpt, "--clip_size", "8", "--stride", "4", "--detect_every", "2",
              "--no_warmup", "--out_video", out])
    assert "frames: 6" in capsys.readouterr().out
    want = []
    for f in read_y4m(path):
        f = f.copy()
        cv2.putText(f, "meeting: ...", (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
        want.append(f)
    ref = str(tmp_path / "want.y4m")
    write_y4m(ref, want, fps=30)
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
