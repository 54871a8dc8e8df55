"""The port's live app, frame sources and X11 capture against the JAX package.

- ``in_exclude_rect`` / ``pick_interlocutor`` give the JAX answers on
  seeded boxes; ``RealtimeApp`` + ``run_loop`` over the same frames and
  weights give the JAX app's verdict and running scores (|Δp| ≤ 1e-4, the
  scorers' tolerance in ``test_torch_scorer_engine.py``), the same overlays
  through ``on_frame`` and, with ``out_video``, a ``.y4m`` of them;
  ``draw_overlay`` on a stub engine equals the JAX overlay bit for bit in
  each verdict state.
- ``X11Connection`` and ``iter_screen_frames`` against the mock X server of
  ``tests/test_x11_capture.py``: frames bit-equal to the JAX client's.
- ``main`` refuses, by name, the flags whose parts are not ported, and runs
  end to end on the CPU: X11 capture from the mock server, the YuNet-shaped
  graph through ``detect_scaled`` in ``AsyncDetector``, a checkpoint the
  port wrote, and the meeting verdict; ``--ckpt`` serves a reference-format
  ``.pth`` at ``--clip_size`` frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.config import PipelineConfig as JaxPipelineConfig
from stdd_tpu.runtime import app as jax_app
from stdd_tpu.runtime import sources as jax_sources
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.runtime.engine import StreamingEngine as JaxStreamingEngine
from stdd_tpu.runtime.x11_capture import X11Connection as JaxX11Connection
from stdd_tpu.runtime.x11_capture import iter_screen_frames as jax_iter_screen_frames
from stdd_torch.config import I3DConfig, PipelineConfig
from stdd_torch.eval.scene import Scene
from stdd_torch.runtime import app, sources
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.runtime.engine import StreamingEngine
from stdd_torch.runtime.x11_capture import X11Connection, iter_screen_frames
from stdd_torch.utils.checkpoint import save_checkpoint
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph
from stdd_torch.utils.video_io import write_y4m
from stdd_torch.utils.weights import i3d_torch_to_flax
from test_x11_capture import MockXServer

from torch_port_helpers import fake_detector, port_i3d_variables

CFG = dict(num_frames=8, crop_size=64)
PIPE = dict(clip_size=8, stride=4, detect_every=2, batch_clips=2, min_face_side=5)


def test_sources_synthetic_and_throttle():
    frames = list(sources.iter_synthetic(5, hw=(120, 160), seed=3))
    want = list(jax_sources.iter_synthetic(5, hw=(120, 160), seed=3))
    assert len(frames) == 5 and frames[0].shape == (120, 160, 3)
    for f, w in zip(frames, want):
        np.testing.assert_array_equal(f, w)
    assert len(list(sources.throttle(iter(frames), 1000.0))) == 5


def test_exclude_rect_and_interlocutor_match_jax():
    H, W = 720, 1280
    rect = (0.70, 0.70, 1.00, 1.00)
    rng = np.random.RandomState(0)
    for _ in range(50):
        n = rng.randint(0, 5)
        xy = rng.uniform(0, [W, H], (n, 2))
        wh = rng.uniform(20, 300, (n, 2))
        boxes = {int(t): np.concatenate([p, p + s]) for t, p, s in zip(rng.permutation(9)[:n],
                                                                        xy, wh)}
        for b in boxes.values():
            assert app.in_exclude_rect(b, H, W, rect) == jax_app.in_exclude_rect(b, H, W, rect)
        assert app.pick_interlocutor(boxes, H, W, rect) == jax_app.pick_interlocutor(
            boxes, H, W, rect)
    # the JAX test's fixed cases: self-view excluded, then the fallback
    self_view, other = np.array([1000, 600, 1200, 700]), np.array([100, 100, 300, 350])
    assert app.pick_interlocutor({1: self_view, 2: other}, H, W, rect) == 2
    assert app.pick_interlocutor({1: self_view}, H, W, rect) == 1
    assert app.pick_interlocutor({}, H, W, rect) is None


class _Track:
    def __init__(self, tid, tlbr, activated=True):
        self.track_id, self.tlbr, self.is_activated = tid, np.asarray(tlbr, np.float32), activated


class _StubEngine:
    """What ``RealtimeApp.draw_overlay`` reads of an engine."""

    def __init__(self, tracks, fake, scores, frames):
        self.tracker = type("T", (), {"tracked": tracks})()
        self.hysteresis = type("H", (), {"fake": fake})()
        self.track_clip_scores = scores
        self.track_frames = frames


@pytest.mark.parametrize("state", ["pending", "real", "fake"])
def test_draw_overlay_matches_jax(state):
    """Two live tracks (one in the self-view corner, so the other is the
    interlocutor ``*``), one partly off-frame, one unconfirmed and one with
    no score yet, under each verdict: bit-equal to the JAX overlay (its cv2
    boxes and labels)."""
    rng = np.random.RandomState(7)
    frame = rng.randint(0, 256, (180, 320, 3)).astype(np.uint8)
    tracks = [_Track(3, (40.4, 30.6, 150.5, 160.2)), _Track(5, (250.0, 140.0, 300.0, 175.0)),
              _Track(8, (-12.0, -20.0, 30.0, 25.0)), _Track(9, (100, 100, 140, 140), False),
              _Track(11, (180.7, 20.2, 230.1, 60.9))]
    level = {"pending": 0.9, "real": 0.1, "fake": 0.9}[state]
    scores = {3: [0.2, level, level], 5: [0.4, 0.61], 8: [level] * 3, 9: [0.5]}
    frames = {3: 40 if state == "pending" else 200, 5: 200, 8: 150, 9: 10, 11: 3}
    fake = {3: True, 5: False, 8: state == "fake"}
    out = []
    for mod in (app, jax_app):
        a = mod.RealtimeApp(_StubEngine(tracks, fake, scores, frames), threshold=0.5,
                            decision_min_frames=128 if state != "pending" else 500)
        before = frame.copy()
        out.append(a.draw_overlay(frame))
        np.testing.assert_array_equal(frame, before)             # the input is not drawn on
    np.testing.assert_array_equal(out[0], out[1])
    assert (out[0] != frame).any()


def test_run_loop_verdict_matches_jax_app(tmp_path):
    variables = port_i3d_variables(I3DConfig(**CFG), seed=0)
    ts = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                        device="cpu")
    js = JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                       use_pallas_warp=False)
    kw = dict(crop_buffer=128, q_weighting=False, q_lap_hard=0.0)
    out = {}
    for name, eng_cls, pipe_cls, scorer, mod in (
            ("torch", StreamingEngine, PipelineConfig, ts, app),
            ("jax", JaxStreamingEngine, JaxPipelineConfig, js, jax_app)):
        eng = eng_cls(scorer, fake_detector(2), cfg=pipe_cls(**PIPE), **kw)
        a = mod.RealtimeApp(eng, threshold=0.0, decision_min_frames=10)
        overlays = []
        # the port also writes the overlay as .y4m; the JAX writer's .mp4 is not compared
        video = str(tmp_path / "overlay.y4m") if name == "torch" else None
        try:
            verdict = mod.run_loop(a, sources.iter_synthetic(16, hw=(240, 320), seed=0),
                                   out_video=video, on_frame=overlays.append)
        finally:
            eng.close()
        out[name] = (verdict, {t: list(s) for t, s in a.running_scores.items()},
                     a.frames_seen, a.last_boxes, overlays)
    (v, scores, n, boxes, ov), (jv, jscores, jn, jboxes, jov) = out["torch"], out["jax"]
    assert len(ov) == len(jov) == 16
    for g, w in zip(ov, jov):                    # boxes, ids, scores and verdicts drawn alike
        np.testing.assert_array_equal(g, w)
    ref = str(tmp_path / "want.y4m")
    write_y4m(ref, ov, fps=30)                   # the file is the in-memory overlays' round trip
    with open(str(tmp_path / "overlay.y4m"), "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="window"):
        app.run_loop(None, [], show=True)
    with pytest.raises(ValueError, match="item 2"):
        app.run_loop(None, [], out_video=str(tmp_path / "o.mp4"))
    assert v == jv == (True, True)      # threshold 0: any scored track flags
    assert n == jn == 16
    assert sorted(scores) == sorted(jscores) and len(scores) == 2
    for t in scores:
        assert len(scores[t]) == len(jscores[t])
        assert np.abs(np.subtract(scores[t], jscores[t])).max() <= 1e-4
    assert sorted(boxes) == sorted(jboxes)
    for t in boxes:
        np.testing.assert_allclose(boxes[t], jboxes[t], atol=1e-4)


_X11_CASES = {
    "lsb_32bpp": dict(bpp=32, byte_order=0),
    "lsb_24bpp": dict(bpp=24, byte_order=0),
    "msb_32bpp": dict(bpp=32, byte_order=1),
    "bgr_visual": dict(masks=(0x0000FF, 0x00FF00, 0xFF0000)),
}


@pytest.mark.parametrize("case", list(_X11_CASES) + ["window_refind", "region"])
def test_x11_frames_bit_equal_to_jax(case):
    """The same mock server (one per client: it serves one connection)
    through both packages' clients gives the same bytes."""
    grabs = {}
    for name, conn_cls, it in (("torch", X11Connection, iter_screen_frames),
                               ("jax", JaxX11Connection, jax_iter_screen_frames)):
        srv = MockXServer(**_X11_CASES.get(case, {}))
        factory = lambda srv=srv, conn_cls=conn_cls: conn_cls(sock=srv.client_sock)  # noqa: E731
        if case in _X11_CASES:
            conn = factory()
            grabs[name] = [conn.get_image(conn.root, 3, 7, 50, 20)]
            want = [srv.expected_bgr(srv.ROOT, 3, 7, 50, 20)]
            conn.close()
        elif case == "region":
            grabs[name] = list(it(region=(20, 30, 64, 48), target_hz=1000.0, max_frames=2,
                                  conn_factory=factory))
            want = [srv.expected_bgr(srv.ROOT, 20, 30, 64, 48)] * 2
        else:
            frames = it(window_title=("Teams",), target_hz=1000.0, max_frames=4,
                        refresh_every=0, conn_factory=factory)
            got = [next(frames) for _ in range(2)]
            # the window dies; the backup Teams window appears: re-find
            srv.windows[0x201]["alive"] = False
            srv.windows[0x204]["mapped"] = True
            grabs[name] = got + list(frames)
            want = [srv.expected_bgr(0x201, 0, 0, 520, 380)] * 2 + \
                [srv.expected_bgr(0x204, 0, 0, 450, 350)] * 2
        assert len(grabs[name]) == len(want)
        for g, w in zip(grabs[name], want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(grabs["torch"], grabs["jax"]):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("argv", [["--source", "clip.mp4"], ["--source", "webcam"],
                                  ["--source", "screen", "--show"],
                                  ["--source", "screen", "--out_video", "o.mp4"],
                                  ["--source", "screen", "--int8"]],
                         ids=["video", "webcam", "show", "out_video", "int8"])
def test_main_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit, match="ROADMAP"):
        app.main(argv + ["--device", "cpu"])


def test_main_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--source screen`` over the mock X server (the scene's frames painted
    on its root window), the YuNet-shaped graph as ``--det_model``, and a
    port-written small checkpoint whose sidecar sets the geometry."""
    ts = ClipScorer.random_init(cfg=I3DConfig(**CFG), device="cpu")
    ckpt = save_checkpoint(str(tmp_path), "i3d", 1, i3d_torch_to_flax(ts.model.state_dict()),
                           metadata={"crop_size": 64, "clip_size": 8, "temporal_only": False})
    det_model = write_onnx(yunet_shaped_graph(0), str(tmp_path / "yunet_shaped.onnx"))
    scene = Scene((240, 320), n_faces=1, seed=0, face_px=96)
    srv = MockXServer(size=(320, 240))
    srv.framebuffers[srv.ROOT] = scene.frame(0)
    captured = []

    def iter_screen(window_title=None, target_hz=8.0, max_frames=None):
        assert window_title is None
        for f in iter_screen_frames(target_hz=1000.0, max_frames=max_frames,
                                    conn_factory=lambda: X11Connection(sock=srv.client_sock)):
            captured.append(f)
            srv.framebuffers[srv.ROOT] = scene.frame(len(captured))
            yield f

    monkeypatch.setattr(sources, "iter_screen", iter_screen)
    app.main(["--source", "screen", "--device", "cpu", "--det_model", det_model,
              "--jax_ckpt", ckpt, "--clip_size", "8", "--stride", "4", "--detect_every", "2",
              "--max_frames", "12", "--profile", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert "meeting verdict: ready=" in out
    assert len(captured) == 12
    np.testing.assert_array_equal(captured[3], scene.frame(3))
    assert (tmp_path / "prof" / "trace.json").exists()


def test_main_serves_a_reference_ckpt(tmp_path, monkeypatch, capsys):
    """``--ckpt`` loads a ``.pth`` in the reference's layout
    (``{"classifier": state_dict}``, keys ``resnet.s2.pathway0_res0.
    branch2.a.weight`` …) through ``ClipScorer.from_torch_checkpoint``, with
    the frames of ``--clip_size``; its weights are the file's."""
    from stdd_torch.utils.torch_convert import i3d_torch_to_reference
    from stdd_torch.utils.weights import i3d_flax_to_torch

    sd = i3d_flax_to_torch(port_i3d_variables(I3DConfig(**CFG), seed=1))
    ref = str(tmp_path / "ref.pth")
    torch.save({"classifier": i3d_torch_to_reference(sd), "epoch": 7}, ref)
    served = []
    load = ClipScorer.from_torch_checkpoint.__func__

    def spy(cls, path, cfg=None, **kw):
        served.append(load(cls, path, cfg=cfg, **kw))
        return served[-1]

    monkeypatch.setattr(ClipScorer, "from_torch_checkpoint", classmethod(spy))
    scene = Scene((240, 320), n_faces=1, seed=0, face_px=96)
    srv = MockXServer(size=(320, 240))
    srv.framebuffers[srv.ROOT] = scene.frame(0)

    def iter_screen(window_title=None, target_hz=8.0, max_frames=None):
        yield from iter_screen_frames(target_hz=1000.0, max_frames=max_frames,
                                      conn_factory=lambda: X11Connection(sock=srv.client_sock))

    monkeypatch.setattr(sources, "iter_screen", iter_screen)
    det_model = write_onnx(yunet_shaped_graph(0), str(tmp_path / "yunet_shaped.onnx"))
    app.main(["--source", "screen", "--device", "cpu", "--det_model", det_model,
              "--ckpt", ref, "--clip_size", "8", "--max_frames", "3", "--no_warmup"])
    assert "meeting verdict: ready=" in capsys.readouterr().out
    scorer, = served
    assert scorer.cfg.num_frames == 8 and scorer.device.type == "cpu"
    got = scorer.model.state_dict()
    assert sorted(got) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
