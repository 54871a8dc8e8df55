"""The port's ClipScorer and StreamingEngine against the JAX package.

Both scorers hold the same variables (the JAX initializers with random BN
statistics) and compute in float32; the JAX scorer takes its exact gather
warp (``use_pallas_warp=False``), the torch scorer K1's plain version (CPU
tensors). Tolerance on probabilities: |Δp| ≤ 1e-4 — the warps differ by a
few float32 ulps of a sample coordinate (``test_torch_align.py``), which
moves a prob by about 1e-6.

The engines see the same frames and the same detector rows (the port's
scene oracle, which is numpy); their per-track score sequences, the order in
which scores come out (strict FIFO) and the verdict must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.config import PipelineConfig as JaxPipelineConfig
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.runtime.engine import StreamingEngine as JaxStreamingEngine
from stdd_torch.config import I3DConfig, PipelineConfig
from stdd_torch.eval.scene import Scene
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.ops.warp import warp_affine
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.runtime.engine import StreamingEngine

from torch_port_helpers import jax_i3d_variables

CFG = dict(num_frames=8, crop_size=64)
PIPE = dict(clip_size=8, imsize=64, stride=4, detect_every=2, batch_clips=2, min_face_side=10)
ENGINE_KW = dict(crop_buffer=160, q_weighting=False, q_lap_hard=0.0, start_conf=0.3,
                 track_kwargs=dict(track_thresh=0.35, match_thresh=0.6, track_buffer=2000,
                                   split_low_scores=False))
P_TOL = 1e-4
FORMATS = ["rgb", "yuv420"]


@pytest.fixture(scope="module")
def variables():
    return jax_i3d_variables(JaxI3DConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def scorers(variables):
    out = {}
    for fmt in FORMATS:
        out[fmt] = (
            JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                          use_pallas_warp=False, upload_format=fmt),
            ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                           upload_format=fmt, device="cpu"),
        )
    return out


def _batch(rng, fmt, B=3, T=8, S=96, n_valid=2):
    """A padded batch as ``pack_clip_batch`` makes it: ``n_valid`` clips of
    a face rotated by up to 20°, then all-zero padded slots."""
    shape = (B, T, S * 3 // 2, S) if fmt == "yuv420" else (B, T, S, S, 3)
    crops = np.zeros(shape, np.uint8)
    crops[:n_valid] = rng.randint(0, 256, (n_valid,) + shape[1:], np.uint8)
    boxes = np.zeros((B, T, 4), np.float32)
    lm5 = np.zeros((B, T, 5, 2), np.float32)
    base = STD_POINTS_256 * (80 / 256.0) + 8.0
    ctr = base.mean(0)
    for b in range(n_valid):
        a = np.radians(rng.uniform(-20, 20))
        rot = (base - ctr) @ np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]]) + ctr
        xy = 200.0 + np.cumsum(rng.uniform(-2, 2, (T, 2)), 0)
        boxes[b, :, :2], boxes[b, :, 2:] = xy, xy + S
        lm5[b] = rot + rng.normal(0, 0.5, (T, 5, 2))
    valid = np.arange(B) < n_valid
    return crops, boxes, lm5, valid


@pytest.mark.parametrize("fmt", FORMATS)
def test_scorer_probs_match_jax(scorers, fmt):
    js, ts = scorers[fmt]
    crops, boxes, lm5, valid = _batch(np.random.RandomState(1), fmt)
    want = np.asarray(js.score(crops, boxes, lm5, valid))
    got = ts.score(crops, boxes, lm5, valid)
    assert got.shape == (3,) and got.dtype == np.float32
    assert np.isfinite(got).all()
    # the padded slot's fit is non-finite; it is masked to 0 on both sides
    assert got[2] == 0.0 and want[2] == 0.0
    assert ((got[:2] > 0) & (got[:2] < 1)).all()
    assert np.abs(got - want).max() <= P_TOL, (got, want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_score_windows_with_scale_fold_matches_jax(scorers, fmt):
    js, ts = scorers[fmt]
    rng = np.random.RandomState(2)
    crops, boxes, lm5, valid = _batch(rng, fmt, B=2, n_valid=2)
    scale = rng.uniform(0.6, 1.0, (2, 8)).astype(np.float32)
    want = np.asarray(js.score_windows([jnp.asarray(c) for c in crops], boxes, lm5, scale, valid))
    handle = ts.score_windows([torch.from_numpy(c) for c in crops], boxes, lm5, scale, valid)
    got = np.asarray(handle)
    assert np.abs(got - want).max() <= P_TOL, (got, want)
    # a clip-uniform scale folded into the warp equals scaling the
    # geometry instead (a similarity absorbs a uniform scale)
    uniform = np.full_like(scale, 0.75)
    folded = np.asarray(ts.score_windows([torch.from_numpy(c) for c in crops], boxes, lm5,
                                         uniform, valid))
    np.testing.assert_allclose(folded, ts.score(crops, boxes * 0.75, lm5 * 0.75, valid), atol=1e-5)


def test_score_async_handle(scorers):
    _, ts = scorers["rgb"]
    crops, boxes, lm5, valid = _batch(np.random.RandomState(3), "rgb", B=2, n_valid=1)
    handle = ts.score_async(crops, boxes, lm5, valid)
    assert handle.is_ready()                       # CPU work is done on return
    got = np.asarray(handle)
    np.testing.assert_array_equal(got, ts.score(crops, boxes, lm5, valid))
    assert np.asarray(handle, dtype=np.float64).dtype == np.float64
    assert got[1] == 0.0


def test_scorer_rejects_wrong_upload_format(scorers):
    _, ts_yuv = scorers["yuv420"]
    crops, boxes, lm5, valid = _batch(np.random.RandomState(4), "rgb", B=1, n_valid=1)
    with pytest.raises(ValueError, match="yuv420"):
        ts_yuv.score(crops, boxes, lm5, valid)


def _run_engine(engine_cls, scorer, pipe_cls, n_frames=36, **kw):
    scene = Scene((240, 320), n_faces=2, seed=0, face_px=72)
    eng = engine_cls(scorer, scene.oracle(PIPE["detect_every"]), cfg=pipe_cls(**PIPE),
                     **ENGINE_KW, **kw)
    try:
        emitted = []
        for i in range(n_frames):
            emitted += eng.step(scene.frame(i))
        emitted += eng.flush()
        verdict = eng.finish()
        per_track = {t: list(s) for t, s in eng.track_clip_scores.items()}
    finally:
        eng.close()
    return emitted, per_track, verdict


# staggered steady-state windows and a provisional first window padded
# with the newest frame: the engine's multi-face and first-verdict options
OPTIONS = dict(stagger_windows=True, early_window_frac=0.5)


@pytest.fixture(scope="module")
def engine_runs(scorers):
    runs = {"launches_before": warp_affine.launches}
    for fmt in FORMATS:
        js, ts = scorers[fmt]
        runs[fmt] = dict(
            jax=_run_engine(JaxStreamingEngine, js, JaxPipelineConfig),
            torch=_run_engine(StreamingEngine, ts, PipelineConfig),
            torch_ring=_run_engine(StreamingEngine, ts, PipelineConfig, device_resident=True),
        )
    js, ts = scorers["rgb"]
    runs["options"] = dict(
        jax=_run_engine(JaxStreamingEngine, js, JaxPipelineConfig, **OPTIONS),
        torch=_run_engine(StreamingEngine, ts, PipelineConfig, **OPTIONS),
        torch_ring=_run_engine(StreamingEngine, ts, PipelineConfig, device_resident=True,
                               **OPTIONS),
    )
    runs["launches_after"] = warp_affine.launches
    return runs


def _assert_same_stream(a, b, tol):
    (ea, ta, va), (eb, tb, vb) = a, b
    # strict FIFO: the same clips come out in the same order
    assert [t for t, _ in ea] == [t for t, _ in eb]
    assert np.abs(np.array([p for _, p in ea]) - np.array([p for _, p in eb])).max() <= tol
    assert sorted(ta) == sorted(tb)
    for t in ta:
        assert len(ta[t]) == len(tb[t]) and np.abs(np.subtract(ta[t], tb[t])).max() <= tol
    assert va.video_fake == vb.video_fake and va.low_quality == vb.low_quality
    assert va.per_person_labels == vb.per_person_labels
    assert abs(va.video_score - vb.video_score) <= tol


@pytest.mark.parametrize("fmt", FORMATS + ["options"])
def test_engine_matches_jax_engine(engine_runs, fmt):
    runs = engine_runs[fmt]
    emitted, per_track, _ = runs["torch"]
    assert len(per_track) == 2 and len(emitted) >= 10
    assert all(0.0 < p < 1.0 for _, p in emitted)
    _assert_same_stream(runs["torch"], runs["jax"], P_TOL)


@pytest.mark.parametrize("fmt", FORMATS + ["options"])
def test_engine_ring_path_matches_packed_path(engine_runs, fmt):
    """Device-resident ring windows (per-frame pack scale folded into the
    warp) against host-packed clips, both in the port: the same pixels and
    geometry reach the scorer, so only float rounding differs."""
    _assert_same_stream(engine_runs[fmt]["torch_ring"], engine_runs[fmt]["torch"], 1e-5)


def test_cpu_engine_never_launches_the_kernel(engine_runs):
    """With ``device="cpu"`` every warp took K1's plain version."""
    assert engine_runs["launches_after"] == engine_runs["launches_before"]


@pytest.mark.parametrize("where", ["push_many", "window"])
def test_failed_ring_upload_drops_only_that_tracks_ring(scorers, engine_runs, monkeypatch, where):
    """One track's failed ring upload (``RingKernels.push_many``) or window
    gather (``RingKernels.window``) raises once: the engine drops that
    track's ring, clears its buffer and keeps scoring, as the JAX engine
    does (``tests/test_ring.py::test_ring_uploader_error_is_per_ring`` and
    ``::test_ring_broken_recovers``); the next frame builds a new ring. The
    other track's scores are those of the run without a fault. This covers
    host-side failures only: a real CUDA fault is sticky and poisons the
    whole context, which no per-ring recovery can undo."""
    from stdd_torch.runtime.ring import RingKernels

    _, ts = scorers["rgb"]
    scene = Scene((240, 320), n_faces=2, seed=0, face_px=72)
    eng = StreamingEngine(ts, scene.oracle(PIPE["detect_every"]), cfg=PipelineConfig(**PIPE),
                          device_resident=True, **ENGINE_KW)
    orig = getattr(RingKernels, where)
    calls, failed = [0], []

    def flaky(self, ring, *args):
        calls[0] += 1
        if calls[0] == 6:
            failed.extend(t for t, r in eng.rings.items() if r.ring is ring)
            raise RuntimeError("injected ring fault")
        return orig(self, ring, *args)

    monkeypatch.setattr(RingKernels, where, flaky)
    emitted, mark = [], None
    try:
        for i in range(36):
            emitted += eng.step(scene.frame(i))
            if failed and mark is None:
                mark = len(emitted)
        emitted += eng.flush()
        per_track = {t: list(s) for t, s in eng.track_clip_scores.items()}
    finally:
        eng.close()
    _, clean, _ = engine_runs["rgb"]["torch_ring"]
    assert len(failed) == 1, "the fault did not hit a ring of the stream"
    hit = failed[0]
    assert len(emitted) > mark, "the stream stopped scoring after the fault"
    assert 0 < len(per_track[hit]) < len(clean[hit])      # recovered, a window short
    for t in clean:
        if t != hit:
            # the same windows; a clip may share its batch with another
            # partner than in the clean run, which moves a float32 prob by
            # ~1e-7
            assert len(per_track[t]) == len(clean[t])
            np.testing.assert_allclose(per_track[t], clean[t], rtol=0, atol=1e-6)
