"""Offline scoring in the port against the JAX package: ``pack_track``,
``ClipScorer.score_dense`` (one track uploaded once, windows sliced on the
device), ``score_with_features`` and ``eval.features.dump_video_features``.

Both scorers hold the same variables (the JAX initializers with random BN
statistics) in float32 on the CPU; the JAX scorer takes its exact gather
warp. Tolerance: |Δp| ≤ 1e-4, and max |Δ| ≤ 1e-4 · max(1, max |ref|) for
logits and pooled features (``tests/test_torch_scorer_engine.py``,
``tests/test_torch_i3d.py``). The model of the dense tests is
``tests/test_demo_path.py:128``.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.config import PipelineConfig as JaxPipelineConfig
from stdd_tpu.eval.features import dump_video_features as jax_dump_video_features
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.runtime.packing import pack_track as jax_pack_track
from stdd_torch.config import I3DConfig, PipelineConfig
from stdd_torch.eval.features import dump_video_features
from stdd_torch.eval.scene import Scene
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.ops.bottleneck import fused_bottleneck
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.runtime.packing import pack_track
from stdd_torch.utils.checkpoint import save_checkpoint
from stdd_torch.utils.weights import i3d_flax_to_torch, i3d_torch_to_flax

from torch_port_helpers import jax_i3d_variables, max_rel_err

CFG = dict(num_frames=8, crop_size=64)
P_TOL = 1e-4
FORMATS = ["rgb", "yuv420"]
S = 96


@pytest.fixture(scope="module")
def variables():
    return jax_i3d_variables(JaxI3DConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def scorers(variables):
    return {fmt: (JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                                use_pallas_warp=False, upload_format=fmt),
                  ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG),
                                                 dtype=torch.float32, upload_format=fmt,
                                                 device="cpu"))
            for fmt in FORMATS}


def _track(rng, n=20, size=(80, 70)):
    """One track's entries: a face drifting a pixel a frame, its landmarks
    jittered; crops of ``size`` (smaller than S: no resize; larger: one
    uniform downscale for the track)."""
    entries = []
    for i in range(n):
        h, w = size
        lm5 = STD_POINTS_256 * (min(h, w) / 256.0) + rng.normal(0, 0.7, (5, 2)) + 4.0
        entries.append(dict(crop=rng.randint(0, 256, (h, w, 3), np.uint8),
                            big_box=np.array([100.0 + i, 50.0, 100.0 + i + w, 50.0 + h],
                                             np.float32),
                            lm5=lm5.astype(np.float32)))
    return entries


@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_track_matches_jax(fmt):
    """No cv2 in the port: the same geometry, the same pixels where the
    track is not resized, within the resize's grey level (3 in I420)
    where it is (``tests/test_torch_host.py``)."""
    rng = np.random.RandomState(0)
    yuv = fmt == "yuv420"
    for size, tol in (((80, 70), 0), ((150, 120), 3 if yuv else 1)):
        entries = _track(rng, n=6, size=size)
        got = pack_track(entries, S, yuv420=yuv)
        want = jax_pack_track(entries, S, yuv420=yuv)
        assert got[0].shape == want[0].shape == ((6, S * 3 // 2, S) if yuv else (6, S, S, 3))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= tol
    with pytest.raises(ValueError):
        pack_track(entries, 90, yuv420=True)


@pytest.mark.parametrize("fmt,clip_size", [("rgb", None), ("yuv420", None), ("rgb", 12)])
def test_score_dense_matches_jax(scorers, fmt, clip_size):
    """The same packed track and starts (the last batch padded): probs
    within 1e-4 of the JAX ``score_dense``; ``clip_size`` other than the
    model's frame count slices windows of that length."""
    js, ts = scorers[fmt]
    frames, boxes, lm5 = jax_pack_track(_track(np.random.RandomState(1)), S,
                                        yuv420=fmt == "yuv420")
    T = clip_size or CFG["num_frames"]
    starts = np.array([0, 3, 5, 20 - T, 7])
    want = np.asarray(js.score_dense(frames, boxes, lm5, starts, batch=3, clip_size=clip_size))
    got = ts.score_dense(frames, boxes, lm5, starts, batch=3, clip_size=clip_size)
    assert got.shape == (5,) and got.dtype == np.float32
    assert ((got > 0) & (got < 1)).all()
    assert np.abs(got - want).max() <= P_TOL, (got, want)


def test_score_dense_equals_packed_windows(scorers):
    """Windows gathered on the device equal the same windows gathered on
    the host and scored as packed clips (the same arithmetic)."""
    _, ts = scorers["yuv420"]
    frames, boxes, lm5 = pack_track(_track(np.random.RandomState(2)), S, yuv420=True)
    starts = np.array([2, 9, 12])
    got = ts.score_dense(frames, boxes, lm5, starts, batch=4)
    idx = starts[:, None] + np.arange(CFG["num_frames"])
    want = ts.score(frames[idx], boxes[idx], lm5[idx], np.ones(3, bool))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ts.score_dense(frames, boxes, lm5, [], batch=4).shape == (0,)


@pytest.mark.parametrize("bad", [[-1], [13], [0, 5, 30]])
def test_score_dense_rejects_out_of_range_starts(scorers, bad):
    """A start outside [0, N - clip_size] raises (an index would otherwise
    wrap or clamp to another window), as in the JAX scorer."""
    js, ts = scorers["rgb"]
    frames, boxes, lm5 = pack_track(_track(np.random.RandomState(3)), S)
    with pytest.raises(ValueError, match="window starts"):
        ts.score_dense(frames, boxes, lm5, bad)
    with pytest.raises(ValueError, match="window starts"):
        js.score_dense(frames, boxes, lm5, bad)


def test_checkpoint_to_fused_s2_dense_matches_jax(tmp_path, variables):
    """The slice end to end: a checkpoint the port writes → the fused-s2
    scorer of each package (K2's plain version; the Pallas kernel in
    interpret mode) → dense windows of one I420 track."""
    path = save_checkpoint(str(tmp_path), "i3d", 1, i3d_torch_to_flax(i3d_flax_to_torch(variables)))
    js = JaxClipScorer.from_jax_checkpoint(path, cfg=JaxI3DConfig(**CFG, fused_s2=True),
                                           dtype=jnp.float32, use_pallas_warp=False,
                                           upload_format="yuv420")
    ts = ClipScorer.from_jax_checkpoint(path, cfg=I3DConfig(**CFG, fused_s2=True),
                                        dtype=torch.float32, upload_format="yuv420", device="cpu")
    frames, boxes, lm5 = pack_track(_track(np.random.RandomState(4), n=14), S, yuv420=True)
    starts = np.array([0, 2, 6])
    before = fused_bottleneck.launches
    got = ts.score_dense(frames, boxes, lm5, starts, batch=2)
    assert fused_bottleneck.launches == before             # CPU: the plain version
    want = np.asarray(js.score_dense(frames, boxes, lm5, starts, batch=2))
    assert np.abs(got - want).max() <= P_TOL, (got, want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_score_with_features_matches_jax(scorers, fmt):
    js, ts = scorers[fmt]
    frames, boxes, lm5 = pack_track(_track(np.random.RandomState(5)), S, yuv420=fmt == "yuv420")
    idx = np.array([0, 6, 0])[:, None] + np.arange(CFG["num_frames"])
    valid = np.array([True, True, False])
    crops, bx, lm = frames[idx], boxes[idx], lm5[idx]
    pj, lj, fj = (np.asarray(a) for a in js.score_with_features(crops, bx, lm, valid))
    pt, lt, ft = ts.score_with_features(crops, bx, lm, valid)
    assert pt.shape == (3,) and lt.shape == (3, 1) and ft.shape == (3, 2048)
    assert pt.dtype == lt.dtype == ft.dtype == np.float32
    assert pt[2] == 0.0 and lt[2] == lt[0]                  # padded: prob masked, logits not
    assert np.abs(pt - pj).max() <= P_TOL
    assert max_rel_err(lt, lj) <= P_TOL and max_rel_err(ft, fj) <= P_TOL
    np.testing.assert_array_equal(pt, ts.score(crops, bx, lm, valid))


PIPE = dict(clip_size=8, imsize=64, stride=4, detect_every=2, batch_clips=2, min_face_side=10)
ENGINE_KW = dict(crop_buffer=160, q_weighting=False, q_lap_hard=0.0, start_conf=0.3,
                 track_kwargs=dict(track_thresh=0.35, match_thresh=0.6, track_buffer=2000,
                                   split_low_scores=False))


def test_dump_video_features_matches_jax(scorers, tmp_path):
    """One scene-oracle video through each package's feature dump (the
    host-packed engine with the feature-capturing facade): the same clips in
    the same order with the same scores, and the same captured logits and
    features. The JAX dump keeps its rows in the order its two dispatch
    lanes happened to finish, which need not be the order of the scores, so
    its rows are compared as a set (sorted by logit); the port pairs each
    row with its own clip, so its score is the sigmoid of its logit."""
    js, ts = scorers["rgb"]
    scene = Scene((240, 320), n_faces=2, seed=0, face_px=72)
    frames = [scene.frame(i) for i in range(30)]
    want = jax_dump_video_features(js, frames, scene.oracle(PIPE["detect_every"]),
                                   cfg=JaxPipelineConfig(**PIPE), **ENGINE_KW)
    out = str(tmp_path / "feats" / "v.npz")
    got = dump_video_features(ts, frames, scene.oracle(PIPE["detect_every"]),
                              cfg=PipelineConfig(**PIPE), out_path=out, **ENGINE_KW)
    assert len(got["tids"]) >= 6 and len(set(got["tids"].tolist())) == 2
    np.testing.assert_array_equal(got["tids"], want["tids"])
    assert got["feats"].shape == (len(got["tids"]), 2048)
    assert np.abs(got["scores"] - want["scores"]).max() <= P_TOL
    np.testing.assert_allclose(got["scores"], 1 / (1 + np.exp(-got["logits"][:, 0])), atol=1e-6)
    og, ow = np.argsort(got["logits"][:, 0]), np.argsort(want["logits"][:, 0])
    assert max_rel_err(got["logits"][og], want["logits"][ow]) <= P_TOL
    assert max_rel_err(got["feats"][og], want["feats"][ow]) <= P_TOL
    saved = np.load(out)
    for k in ("feats", "logits", "scores", "tids"):
        np.testing.assert_array_equal(saved[k], got[k])


class _ValueScorer:
    """A model-free ``score_with_features``: clip k's value v (its mean
    pixel and box) is its logit and fills its features; its prob is
    sigmoid(v), or 1.0 for every clip with ``saturate`` (a trained scorer's
    float32 sigmoid is exactly 1 above a logit of about 17). With ``stall``
    the first call waits until a second call has returned, so the second
    dispatch lane finishes its batch first."""

    upload_format = "rgb"

    def __init__(self, saturate: bool, stall: bool):
        self.saturate, self.stall = saturate, stall
        self.calls = []                       # logits of each call, in return order
        self._started = 0
        self._lock = threading.Lock()
        self._second_done = threading.Event()

    def score_with_features(self, crops, boxes, lm5, valid):
        with self._lock:
            k = self._started
            self._started += 1
        if self.stall and k == 0:
            assert self._second_done.wait(10), "no second batch was dispatched"
        v = (crops.reshape(len(crops), -1).mean(1) / 255.0
             + boxes[:, :, :2].mean((1, 2)) / 1000.0).astype(np.float32)
        probs = np.ones_like(v) if self.saturate else 1 / (1 + np.exp(-v))
        n = int(valid.sum())
        with self._lock:
            self.calls.append(v[:n])
        if k == 1:
            self._second_done.set()
        return probs, v[:, None], np.repeat(v[:, None], 2048, 1)


def test_dump_video_features_pairs_saturated_probs():
    """Features follow the emitted score of their own clip even when every
    prob is 1.0 and the dispatch lanes finish out of order: the stalled,
    saturated run captures the same rows in the same order as a run whose
    distinct probs show the pairing (score = sigmoid(logit)), while the
    order in which its calls returned (the JAX facade's order) differs from
    the order of its scores."""
    scene = Scene((240, 320), n_faces=2, seed=0, face_px=72)
    frames = [scene.frame(i) for i in range(30)]
    runs = {}
    for saturate in (False, True):
        stub = _ValueScorer(saturate=saturate, stall=saturate)
        runs[saturate] = (stub, dump_video_features(
            stub, frames, scene.oracle(PIPE["detect_every"]), cfg=PipelineConfig(**PIPE),
            **ENGINE_KW))
    (_, a), (stub, b) = runs[False], runs[True]
    assert len(a["tids"]) >= 6 and len(np.unique(a["logits"])) == len(a["tids"])
    np.testing.assert_array_equal(a["scores"], 1 / (1 + np.exp(-a["logits"][:, 0])))
    np.testing.assert_array_equal(a["feats"][:, 0], a["logits"][:, 0])
    assert (b["scores"] == 1.0).all()
    for k in ("tids", "logits", "feats"):
        np.testing.assert_array_equal(b[k], a[k])
    assert not np.array_equal(np.concatenate(stub.calls), b["logits"][:, 0])
