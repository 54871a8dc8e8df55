"""The port's program spans, counters and per-window record, and the
benchmark's readers of the spans, on the CPU.

- ``utils/spans.py::span`` builds no ``_RecordFunctionFast`` with the
  profiler off (a counting stand-in, not a timer);
- under ``utils/misc.py::profiler_trace`` a tiny ``MultiStreamServer``
  with device rings (the live cell's path) records every stepping-thread
  span, nested in ``stdd.engine.step``, and the lanes' and the scorer's
  spans on the lanes' threads; ``score_dense`` records its upload and
  fetch; the app's ``--profile`` holds the lane's and the detector's;
- on a scripted oracle scene ``stats()`` balances after a flush (windows
  enqueued = routed + stale + failed), a planted ring-push failure and a
  failed batch each counted once, and ``windows()`` holds the frames and
  geometry each window shipped;
- ``portbench/metrics``' span readers on a hand-built ``Trace``.
"""

import json

import numpy as np
import pytest
import torch

from portbench.lib.registry import metric_readers
from portbench.lib.trace import Trace
from stdd_torch.config import I3DConfig, PipelineConfig
from stdd_torch.eval.scene import Scene
from stdd_torch.models import yunet
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.runtime import app, classifier
from stdd_torch.runtime import ring as ring_mod
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.runtime.engine import AsyncDetector
from stdd_torch.runtime.server import MultiStreamServer
from stdd_torch.utils import spans
from stdd_torch.utils.misc import profiler_trace
from stdd_torch.utils.video_io import write_y4m

CFG = I3DConfig(num_frames=8, crop_size=32, width_per_group=4)
PIPE = PipelineConfig(clip_size=8, stride=4, detect_every=2, batch_clips=2, min_face_side=10)
ENG_KW = dict(crop_buffer=64, q_lap_hard=0.0, q_lap_soft=0.0, q_weighting=False)
HW = (128, 160)

STEPPING = ("stdd.engine.detect", "stdd.engine.track", "stdd.engine.crop_gate",
            "stdd.ring.pack", "stdd.ring.upload", "stdd.engine.emit", "stdd.dispatch.tick")
LANES = ("stdd.lane.launch", "stdd.lane.wait", "stdd.lane.route",
         "stdd.scorer.decode", "stdd.scorer.align", "stdd.scorer.trunk")


@pytest.fixture(scope="module")
def scorer():
    return ClipScorer.random_init(cfg=CFG, dtype=torch.float32, device="cpu",
                                  upload_format="yuv420")


def _serve(scorer, n_frames):
    """Step an oracle scene of two faces through a server with device rings,
    then flush → (server, scores); the server is left open."""
    server = MultiStreamServer(scorer, cfg=PIPE, device_resident=True, **ENG_KW)
    scene = Scene(HW, n_faces=2, seed=0, face_px=48)
    sid = server.add_stream(AsyncDetector(scene.oracle(PIPE.detect_every)))
    scores = []
    for i in range(n_frames):
        scores += server.step(sid, scene.frame(i))
    scores += server.flush(sid)
    return server, scores


def _balanced(st):
    return (st["windows_full"] + st["windows_early"]
            == st["windows_routed"] + st["windows_stale"] + st["windows_failed"])


def test_span_with_the_profiler_off_builds_nothing(scorer, monkeypatch):
    made = []

    class Counting:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans, "_RecordFunctionFast", Counting)
    with spans.span("stdd.test"):
        pass
    server, scores = _serve(scorer, 10)
    server.close()
    assert scores and made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("stdd.test"):
            pass
    assert made == ["stdd.test"]


def test_live_spans_nest_in_the_step_and_lanes_record_theirs(scorer, tmp_path):
    with profiler_trace(str(tmp_path)):
        server, scores = _serve(scorer, 16)
    server.close()
    assert scores
    events = [e for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]
              if e.get("name", "").startswith("stdd.") and e.get("ph") == "X"]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    missing = set(STEPPING + LANES + ("stdd.engine.step",)) - set(by)
    assert not missing, sorted(missing)
    stepper = {e["tid"] for e in by["stdd.engine.step"]}
    assert len(stepper) == 1
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in by["stdd.engine.step"])
    assert len(steps) == 16
    eps = 1e-3                                   # µs: the export's rounding
    for name in STEPPING:
        for e in by[name]:
            assert e["tid"] in stepper, name
            assert any(a - eps <= e["ts"] and e["ts"] + e["dur"] <= b + eps
                       for a, b in steps), (name, e["ts"])
    for name in LANES:
        assert all(e["tid"] not in stepper for e in by[name]), name


def test_score_dense_records_upload_and_fetch(scorer):
    S, n = 40, 12
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n, S * 3 // 2, S), dtype=np.uint8)
    boxes = np.tile(np.float32([0, 0, S, S]), (n, 1))
    lm5 = np.tile((STD_POINTS_256 * S / 256.0).astype(np.float32), (n, 1, 1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        probs = scorer.score_dense(frames, boxes, lm5, [0, 1, 4], batch=2)
    assert probs.shape == (3,) and np.isfinite(probs).all()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name in ("stdd.scorer.upload", "stdd.scorer.fetch", "stdd.scorer.decode",
                 "stdd.scorer.align", "stdd.scorer.trunk"):
        assert name in names, name
    assert names.count("stdd.scorer.upload") == names.count("stdd.scorer.fetch") == 1
    assert names.count("stdd.scorer.trunk") == 2


def test_stats_balance_with_a_failed_push_and_a_failed_batch(scorer, monkeypatch):
    orig_push = ring_mod.DeviceRing.push
    pushes = [0]

    def push(ring, crop, big_box, lm5):
        pushes[0] += 1
        if pushes[0] == 5:
            raise RuntimeError("planted push failure")
        return orig_push(ring, crop, big_box, lm5)

    monkeypatch.setattr(ring_mod.DeviceRing, "push", push)
    server = MultiStreamServer(scorer, cfg=PIPE, device_resident=True, **ENG_KW)
    group = server._root._group
    orig_score = group._score_batch
    failed = []

    def score_batch(batch):
        if not failed:
            failed.append(len(batch))
            raise RuntimeError("planted batch failure")
        return orig_score(batch)

    group._score_batch = score_batch
    scenes = [Scene(HW, n_faces=2, seed=k, face_px=48) for k in range(2)]
    sids = [server.add_stream(AsyncDetector(sc.oracle(PIPE.detect_every))) for sc in scenes]
    try:
        for i in range(20):
            for sid, sc in zip(sids, scenes):
                try:
                    server.step(sid, sc.frame(i))
                except RuntimeError as e:
                    assert "scoring worker failed" in str(e)
        for sid in sids:
            try:
                server.flush(sid)
            except RuntimeError as e:
                assert "scoring worker failed" in str(e)
        st = server.stats()
        assert st["frames"] == 40 and st["detect_frames"] == 20
        assert st["ring_failures"] == 1
        assert st["batches_failed"] == 1 and st["windows_failed"] == failed[0] >= 1
        assert st["windows_routed"] > 0 and st["windows_stale"] == 0
        assert st["windows_shipped"] == st["windows_full"] + st["windows_early"]
        assert st["dropped_no_landmarks"] == st["dropped_quality"] == 0
        assert st["faces_tracked"] == 80
        assert _balanced(st), st
        server.finish(sids[0])                   # a finished stream still counts
        after = server.stats()
        assert after["frames"] == 40 and _balanced(after), after
    finally:
        server.close()


@pytest.mark.parametrize("device_resident", [True, False], ids=["rings", "host_packed"])
def test_window_record_is_what_shipped(scorer, device_resident):
    server = MultiStreamServer(scorer, cfg=PIPE, device_resident=device_resident, **ENG_KW)
    group = server._root._group
    shipped = []
    now = {}
    orig_enqueue = group.enqueue

    def enqueue(clip):
        shipped.append((clip, now[clip.owner.stream_id]))
        orig_enqueue(clip)

    group.enqueue = enqueue
    scenes = [Scene(HW, n_faces=2, seed=k, face_px=48) for k in range(2)]
    sids = [server.add_stream(AsyncDetector(sc.oracle(PIPE.detect_every))) for sc in scenes]
    scores = {}
    try:
        for i in range(20):
            for sid, sc in zip(sids, scenes):
                now[sid] = i
                for tid, p in server.step(sid, sc.frame(i)):
                    scores.setdefault((sid, tid), []).append(p)
        for sid in sids:
            for tid, p in server.flush(sid):
                scores.setdefault((sid, tid), []).append(p)
        records = server.windows()
        st = server.stats()
    finally:
        server.close()
    T = PIPE.clip_size
    assert len(records) == len(shipped) == st["windows_routed"] > 0
    got = {}
    for r in records:
        clip, k = next((c, k) for c, k in shipped
                       if (c.t_enq, c.owner.stream_id, c.tid) == (r.t_enq, r.stream, r.tid))
        assert r.kind == "full"
        np.testing.assert_array_equal(r.frames, np.arange(k - T + 1, k + 1))
        if device_resident:
            _, boxes, lm5, scale = clip.window
            assert r.boxes is boxes and r.lm5 is lm5 and r.scale is scale
        else:
            np.testing.assert_array_equal(r.boxes, np.stack([e.big_box for e in clip.entries]))
            np.testing.assert_array_equal(r.lm5, np.stack([e.lm5 for e in clip.entries]))
            s = min(1.0, ENG_KW["crop_buffer"] / max(max(e.crop.shape[:2])
                                                     for e in clip.entries))
            np.testing.assert_array_equal(r.scale, np.full(T, s, np.float32))
        assert r.t_enq <= r.t_dispatch <= r.t_routed
        assert 1 <= r.batch_size <= PIPE.batch_clips
        got.setdefault((r.stream, r.tid), []).append(r.prob)
    assert got == scores


def test_app_profile_holds_the_lane_and_detector_spans(tmp_path, monkeypatch, capsys):
    """``app.main --profile`` over a ``.y4m`` of the oracle scene: the
    scorer is the tiny one, and the detector a stand-in whose rows are the
    oracle's behind the real ``detect_scaled`` (and its span)."""
    scene = Scene(HW, n_faces=2, seed=0, face_px=48)
    src = str(tmp_path / "call.y4m")
    write_y4m(src, (scene.frame(i) for i in range(12)))
    tiny = ClipScorer.random_init(cfg=CFG, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(classifier, "load_scorer", lambda *a, **kw: tiny)

    class OracleYuNet:
        def __init__(self, path, cfg, device="cpu"):
            self.input_size = (HW[1], HW[0])          # the frame's: rows scale by 1
            self.stream = None
            self.rows = scene.oracle(2)

        def _on_device(self, frames):
            return torch.from_numpy(np.ascontiguousarray(frames))

        def detect_np(self, small):
            return self.rows(small)

    monkeypatch.setattr(yunet, "YuNet", OracleYuNet)
    app.main(["--source", src, "--device", "cpu", "--det_model", "oracle", "--clip_size", "8",
              "--stride", "4", "--detect_every", "2", "--profile", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert "frames: 12" in out
    stats = dict(kv.split("=") for kv in out.split("stats: ", 1)[1].split())
    assert int(stats["frames"]) == 12 and int(stats["windows_routed"]) >= 1
    threads = {}
    for e in json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]:
        if e.get("name", "").startswith("stdd."):
            threads.setdefault(e["name"], set()).add(e["tid"])
    names = ("stdd.engine.step", "stdd.lane.launch", "stdd.detector.detect")
    assert set(names) <= set(threads), sorted(threads)
    step, lane, det = (threads[n] for n in names)
    assert step.isdisjoint(lane) and step.isdisjoint(det) and lane.isdisjoint(det)


def _trace(spans_ms, kind="live"):
    names = [n for n, _, _ in spans_ms]
    start = np.asarray([int(a * 1e6) for _, a, _ in spans_ms], np.int64)
    end = np.asarray([int(b * 1e6) for _, _, b in spans_ms], np.int64)
    empty = np.zeros(0, np.int64)
    return {"kind": kind, "trace": Trace([], empty, empty, empty, names, start, end, 1.0)}


LIVE_SPANS = [
    ("portbench.step", -1, 11), ("stdd.engine.step", 0, 10),
    ("stdd.engine.detect", 0, 1), ("stdd.engine.track", 1, 2),
    ("stdd.engine.crop_gate", 2, 3), ("stdd.engine.crop_gate", 3, 4),
    ("stdd.ring.pack", 4, 5), ("stdd.engine.emit", 5, 7), ("stdd.ring.upload", 5.5, 6.5),
    ("stdd.dispatch.tick", 8, 9), ("aten::copy_", 9.1, 9.5),
    ("stdd.engine.step", 20, 30), ("stdd.engine.track", 20, 21), ("stdd.ring.pack", 22, 24),
    ("stdd.ring.upload", 24, 25), ("stdd.dispatch.tick", 29, 30),
    ("stdd.lane.launch", 21, 28),                 # another thread's: not a step's child
]
EXPECTED = {
    "host.detect_ms.live": 0.5, "host.track_ms.live": 1.0, "host.crop_gate_ms.live": 1.0,
    "host.pack_ms.live": 1.5, "host.upload_ms.live": 1.0,
    "host.step_self_ms.live": (2.0 + 5.0) / 2,
    "scorer.track_upload_ms.dense": 1.5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_readers(name):
    reader = metric_readers()[name]
    assert reader.UNIT == "ms"
    live = _trace(LIVE_SPANS)
    dense = _trace([("portbench.score_dense", 0, 9), ("stdd.scorer.upload", 0, 2),
                    ("stdd.scorer.upload", 5, 6), ("stdd.scorer.fetch", 8, 9)], kind="dense")
    on, off = (dense, live) if name.endswith(".dense") else (live, dense)
    assert reader.read(on) == pytest.approx(EXPECTED[name], abs=1e-9)
    assert reader.read(off) is None
    assert reader.read({"kind": on["kind"], "trace": None}) is None
    # a program that records no spans (the parent's) reads nothing
    assert reader.read(_trace([("portbench.step", 0, 10)], kind=on["kind"])) is None
