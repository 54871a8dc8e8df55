"""The port's MultiStreamServer and shared dispatch group, on the CPU.

The cases of ``tests/test_server.py`` and ``tests/test_worker_routing.py``
that need no cv2, run on the port (small I3D, float32, ``device="cpu"``,
so every warp takes K1's plain version), and one server-vs-JAX-server case:
the same frames and weights through both packages' servers give the same
per-stream, per-track score sequences within 1e-4 (the warps differ by a
few float32 ulps of a sample coordinate, ``test_torch_align.py``).

Tolerances inside the port: a clip can land in a batch of another capacity
or with another partner in the server than when its stream runs alone,
which moves a float32 prob by ~1e-7; 1e-5 bounds that.
"""

import gc
import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.config import PipelineConfig as JaxPipelineConfig
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.runtime.server import MultiStreamServer as JaxMultiStreamServer
from stdd_torch.config import I3DConfig, PipelineConfig
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.runtime.dispatch import _PendingClip
from stdd_torch.runtime.engine import StreamingEngine
from stdd_torch.runtime.server import MultiStreamServer

from torch_port_helpers import fake_detector, port_i3d_variables

CFG = dict(num_frames=8, crop_size=64)
PIPE_KW = dict(clip_size=8, imsize=64, stride=4, detect_every=2, batch_clips=2, min_face_side=10)
PIPE = PipelineConfig(**PIPE_KW)
ENG_KW = dict(crop_buffer=160, q_lap_hard=0.0, q_lap_soft=0.0, q_weighting=False)
TOL = 1e-5
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def scorer():
    return ClipScorer.random_init(cfg=I3DConfig(**CFG), dtype=torch.float32, device="cpu")


def _frame(seed=0, h=240, w=320):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


def _per_track(scored):
    out = {}
    for tid, p in scored:
        out.setdefault(tid, []).append(p)
    return out


def _solo(scorer, n_steps, frame, **kw):
    eng = StreamingEngine(scorer, fake_detector(), cfg=PIPE, **ENG_KW, **kw)
    try:
        out = []
        for _ in range(n_steps):
            out += eng.step(frame)
        out += eng.flush()
    finally:
        eng.close()
    return _per_track(out)


def _assert_same_tracks(got, want, tol):
    assert want and set(got) == set(want), (got, want)
    for tid in want:
        assert len(got[tid]) == len(want[tid])
        np.testing.assert_allclose(got[tid], want[tid], rtol=0, atol=tol)


def test_two_streams_match_standalone_and_the_jax_server(scorer):
    """Batches mix clips from both calls; every per-clip score equals the
    score the stream gets when served alone, and the JAX server's on the
    same frames and weights."""
    variables = port_i3d_variables(I3DConfig(**CFG), seed=0)
    ts = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                        device="cpu")
    js = JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                       use_pallas_warp=False)
    frame = _frame()
    solo = _solo(ts, 16, frame)
    got = {}
    for name, server in (("torch", MultiStreamServer(ts, cfg=PIPE, **ENG_KW)),
                         ("jax", JaxMultiStreamServer(js, cfg=JaxPipelineConfig(**PIPE_KW),
                                                      **ENG_KW))):
        a = server.add_stream(fake_detector())
        b = server.add_stream(fake_detector())
        out = {a: [], b: []}
        try:
            for _ in range(16):
                out[a] += server.step(a, frame)
                out[b] += server.step(b, frame)
            out[a] += server.flush(a)
            out[b] += server.flush(b)
        finally:
            server.close()
        got[name] = [_per_track(out[a]), _per_track(out[b])]
    for sid in (0, 1):
        _assert_same_tracks(got["torch"][sid], solo, TOL)
        _assert_same_tracks(got["torch"][sid], got["jax"][sid], JAX_TOL)


def test_finish_one_stream_keeps_peer_alive(scorer):
    frame = _frame()
    server = MultiStreamServer(scorer, cfg=PIPE, **ENG_KW)
    try:
        a = server.add_stream(fake_detector())
        b = server.add_stream(fake_detector())
        for _ in range(20):
            server.step(a, frame)
            server.step(b, frame)
        verdict = server.finish(a)
        assert verdict.raw_scores, "finished call aggregates its clips"
        assert a not in server.streams
        more = []
        for _ in range(12):
            more += server.step(b, frame)
        more += server.flush(b)
        assert more, "surviving stream keeps scoring after a peer ends"
    finally:
        server.close()


def test_secondary_reset_drops_stale_scores_only(scorer):
    """Resetting one stream mid-flight must not leak its old scores into the
    new stream, and must not drop the peer's."""
    frame = _frame()
    server = MultiStreamServer(scorer, cfg=PIPE, **ENG_KW)
    try:
        a = server.add_stream(fake_detector())
        b = server.add_stream(fake_detector())
        for _ in range(12):   # enough to enqueue clips, not to harvest them all
            server.step(a, frame)
            server.step(b, frame)
        gen = server.engine(a)._gen
        server.engine(a).reset()
        assert server.engine(a)._gen == gen + 1
        out_a = server.flush(a)
        out_b = server.flush(b)
        assert out_a == []          # stale generation dropped
        assert out_b                # peer unaffected
        assert server.engine(a).track_clip_scores == {}
    finally:
        server.close()


@pytest.mark.parametrize("device_resident", [False, True], ids=["packed", "rings"])
def test_concurrent_threaded_streams_match_standalone(scorer, device_resident):
    """The deployment shape: each call stepped from its own thread. The
    shared group's pending/seq/harvest state stays consistent: every
    stream's per-track score sequence equals its standalone run."""
    frame = _frame()
    solo = _solo(scorer, 24, frame, device_resident=device_resident)
    server = MultiStreamServer(scorer, cfg=PIPE, device_resident=device_resident, **ENG_KW)
    sids = [server.add_stream(fake_detector()) for _ in range(3)]
    got = {sid: [] for sid in sids}
    errs = []

    def run(sid):
        try:
            for _ in range(24):
                got[sid] += server.step(sid, frame)
            got[sid] += server.flush(sid)
        except BaseException as e:   # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=run, args=(sid,)) for sid in sids]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        # a racing flush may route results into a peer's ready list before
        # this stream's own flush returns; collect the remainder
        for sid in sids:
            got[sid] += server.engine(sid)._take_ready()
    finally:
        server.close()
    for sid in sids:
        _assert_same_tracks(_per_track(got[sid]), solo, TOL)


def test_server_warmup_runs_all_capacities(scorer, monkeypatch):
    seen = []
    orig = scorer.warmup

    def spy(crop_buffer, caps, clip_size, windows=False):
        seen.append((crop_buffer, tuple(caps), clip_size, windows))
        return orig(crop_buffer, caps, clip_size, windows=windows)

    monkeypatch.setattr(scorer, "warmup", spy)
    server = MultiStreamServer(scorer, cfg=PIPE, **ENG_KW)
    try:
        server.warmup()   # PIPE.batch_clips=2 → capacities (1, 2)
    finally:
        server.close()
    assert seen == [(160, (1, 2), PIPE.clip_size, False)]


def test_secondary_engine_delegates_group_attrs(scorer):
    server = MultiStreamServer(scorer, cfg=PIPE, **ENG_KW)
    try:
        eng = server.engine(server.add_stream(fake_detector()))
        assert eng.clip_latencies is server._root.clip_latencies
        assert eng.pending is server._root.pending
        with pytest.raises(AttributeError):
            eng.no_such_attribute
    finally:
        server.close()


def test_secondary_reset_clears_its_pending_clips(scorer):
    # huge batch so nothing dispatches; pending accumulates
    pipe = PipelineConfig(**dict(PIPE_KW, batch_clips=64))
    server = MultiStreamServer(scorer, cfg=pipe, max_batch_wait_frames=10 ** 9, **ENG_KW)
    try:
        a = server.add_stream(fake_detector())
        b = server.add_stream(fake_detector())
        frame = _frame()
        for _ in range(20):
            server.step(a, frame)
            server.step(b, frame)
        eng_a = server.engine(a)
        assert any(c.owner is eng_a for c in server._root.pending)
        eng_a.reset()
        assert not any(c.owner is eng_a for c in server._root.pending)
        assert any(c.owner is server.engine(b) for c in server._root.pending)
    finally:
        server.close()


def test_shared_dispatch_validation(scorer):
    other = ClipScorer(scorer.model.state_dict(), cfg=I3DConfig(**CFG), dtype=torch.float32,
                       device="cpu")
    root = StreamingEngine(scorer, fake_detector(), cfg=PIPE, max_batch_wait_frames=5, **ENG_KW)
    engines = [root]
    try:
        with pytest.raises(ValueError, match="one scorer"):
            StreamingEngine(other, fake_detector(), cfg=PIPE, share_dispatch_from=root, **ENG_KW)
        with pytest.raises(ValueError, match="crop_buffer"):
            StreamingEngine(scorer, fake_detector(), cfg=PIPE, share_dispatch_from=root,
                            **dict(ENG_KW, crop_buffer=96))
        with pytest.raises(ValueError, match="device_resident"):
            StreamingEngine(scorer, fake_detector(), cfg=PIPE, share_dispatch_from=root,
                            device_resident=True, **ENG_KW)
        with pytest.raises(ValueError, match="group-level"):
            StreamingEngine(scorer, fake_detector(), cfg=PIPE, share_dispatch_from=root,
                            max_batch_wait_frames=7, **ENG_KW)
        # the root's value or the default are fine
        for kw in (dict(max_batch_wait_frames=5), {}):
            engines.append(StreamingEngine(scorer, fake_detector(), cfg=PIPE,
                                           share_dispatch_from=root, **kw, **ENG_KW))
        with pytest.raises(ValueError, match="group-root"):
            StreamingEngine(scorer, fake_detector(), cfg=PIPE, share_dispatch_from=engines[1],
                            **ENG_KW)
    finally:
        for e in engines:
            e.close()


def test_server_ring_mode_defaults_to_eager_dispatch(scorer):
    """In device-ring mode window dispatches carry no pixels, so the server
    inherits the engine's eager default (wait 0) instead of holding a
    sparse call's window a whole stride for peers."""
    for resident, want in ((True, 0), (False, PIPE.stride)):
        srv = MultiStreamServer(scorer, cfg=PIPE, device_resident=resident, **ENG_KW)
        try:
            assert srv._root.max_batch_wait_frames == want
        finally:
            srv.close()


def test_close_stops_lanes_and_frees_the_graph(scorer):
    """The per-video serving pattern (fresh engine per call, close() after)
    accumulates no threads, and a closed engine's object graph can be
    collected; a closed server drops its streams."""
    base = threading.active_count()
    refs = []
    for i in range(3):
        eng = StreamingEngine(scorer, fake_detector(), cfg=PIPE, device_resident=True, **ENG_KW)
        for _ in range(8):
            eng.step(_frame(seed=i))
        eng.flush()
        lanes = list(eng._group._workers)
        assert lanes and all(w.is_alive() for w in lanes)
        eng.close()
        eng.close()                              # idempotent
        assert not eng.rings
        for w in lanes:
            w.join(timeout=5.0)
            assert not w.is_alive()
        refs.append(weakref.ref(eng))
        del eng
    deadline = time.time() + 15
    while threading.active_count() > base and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= base, threading.enumerate()
    gc.collect()
    assert not [r for r in refs if r() is not None], "closed engines still pinned in memory"

    server = MultiStreamServer(scorer, cfg=PIPE, device_resident=True, **ENG_KW)
    a = server.add_stream(fake_detector())
    for _ in range(10):
        server.step(a, _frame())
    server.flush(a)
    lanes = list(server._root._group._workers)
    server.close()
    assert not server.streams
    for w in lanes:
        w.join(timeout=5.0)
        assert not w.is_alive()


def test_ring_lane_routes_scores_without_a_step_tick(scorer):
    """In ring mode the lane materializes a batch's probs and routes them
    itself: a scored window reaches its owner with no further step()."""
    eng = StreamingEngine(scorer, fake_detector(), cfg=PIPE, device_resident=True, **ENG_KW)
    frame = _frame(seed=1)
    try:
        for _ in range(80):
            eng.step(frame)
            if eng._group._next_seq > 0:
                break
        assert eng._group._next_seq > 0, "no batch was ever dispatched"
        eng._group._dispatch_q.join()
        assert eng._group.inflight == []
        assert eng._group._next_harvest_seq == eng._group._next_seq
        scored = eng._take_ready()
        assert scored and all(0.0 <= p <= 1.0 for _, p in scored)
    finally:
        eng.close()


def test_mixed_ring_and_packed_batch_stays_async(scorer, monkeypatch):
    """With max_rings exhausted a crowd-overflow track ships host-packed
    inside a ring-mode batch; the lane does not materialize such a mixed
    batch, and the normal flush still routes every score."""
    eng = StreamingEngine(scorer, fake_detector(2), cfg=PIPE, device_resident=True,
                          max_rings=1, **ENG_KW)
    group = eng._group
    kinds = []
    orig = group._score_batch

    def spy(batch):
        kinds.append(sorted({c.window is not None for c in batch}))
        return orig(batch)

    monkeypatch.setattr(group, "_score_batch", spy)
    frame = _frame(seed=1)
    try:
        for _ in range(60):
            eng.step(frame)
            if group._next_seq > 0:
                break
        group._dispatch_q.join()
        assert [False, True] in kinds, f"fixture made no mixed batch: {kinds}"
        with group._lock:
            pending = sorted(group.inflight, key=lambda e: e[0])
        assert pending, "mixed batch was routed on the lane (async path lost)"
        _, batch, dev, _ = pending[0]
        parts = dev if isinstance(dev, list) else [(range(len(batch)), dev)]
        assert not all(isinstance(d, np.ndarray) for _, d in parts)
        scored = eng.flush()
        assert scored and all(0.0 <= p <= 1.0 for _, p in scored)
        assert len(eng.track_clip_scores) == 2, "both faces must be scored"
    finally:
        eng.close()


@pytest.mark.parametrize("where", ["routing", "scoring"])
def test_failure_surfaces_only_to_the_failing_batchs_stream(scorer, monkeypatch, where):
    """An exception while routing a harvested batch, or while scoring one on
    a lane, reaches only the streams that own that batch's clips — never
    the stream whose thread happened to harvest, never as a raise out of
    harvest() — and the FIFO cursor still advances."""
    a = StreamingEngine(scorer, lambda f: np.empty((0, 15)), cfg=PIPE, **ENG_KW)
    b = StreamingEngine(scorer, lambda f: np.empty((0, 15)), cfg=PIPE, share_dispatch_from=a,
                        **ENG_KW)
    group = a._group
    clip = _PendingClip(tid=7, entries=[], owner=a, owner_gen=a._gen, t_enq=time.perf_counter())
    try:
        if where == "routing":
            class Poison:
                def update(self, tid, p):
                    raise RuntimeError("poisoned track state")

                def drop(self, tid):
                    pass

            a.hysteresis = Poison()
            with group._lock:
                group.inflight.append((group._next_seq, [clip], np.array([0.5], np.float32),
                                       time.perf_counter()))
            group._next_seq += 1
            group.harvest(block=True)            # B's thread harvests A's batch: no raise
        else:
            def boom(batch):
                raise RuntimeError("scoring failed")

            monkeypatch.setattr(group, "_score_batch", boom)
            group.enqueue(clip)
            group.drain_snapshot()
            group._dispatch_q.join()
            group.harvest(block=True)
        assert group._next_harvest_seq == group._next_seq, "cursor jammed"
        assert isinstance(a._worker_error, RuntimeError)
        assert b._worker_error is None, "error misrouted to a peer stream"
        with pytest.raises(RuntimeError, match="scoring worker failed"):
            a.step(np.zeros((120, 160, 3), np.uint8))
        b.step(np.zeros((120, 160, 3), np.uint8))   # B is unaffected
    finally:
        b.close()
        a.close()
