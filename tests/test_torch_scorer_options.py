"""The scorer's constructor options against the JAX scorer:
``round_aligned_u8`` (the reference's uint8 quantization of the aligned
clip, between K1 and the normalize) and ``score_index``; and the JAX
scorer's ``s2d_stem``, ``use_pallas_warp`` and ``warp_band``, which the
port does not take, against the port's plain scorer.

Both scorers hold the same variables (the JAX initializers with random BN
statistics) in float32 on the CPU, at the smallest I3D that shows the
property (width 8, 4 frames, a 64 crop); the JAX scorer takes its exact
gather warp, the port K1's plain version. Tolerance: |Δp| ≤ 1e-4, and max
|Δ| ≤ 1e-4 · max(1, max |ref|) for logits and pooled features
(``tests/test_torch_dense.py``), but for the rounded features.

Rounded, the two scorers' clips differ by one grey level wherever their
unrounded values lie on either side of a half. The two similarity solves
sum in another order in float32, which moves a sample of these iid-noise
crops (up to 255 grey levels a pixel) by up to 0.03 grey levels: 0.3% of
the values round to the other level (400 of 147,456 here), which moves the
pooled features by up to 2e-4 of max(1, max |ref|), the logits by 2e-5 and
the probs by 5e-6. So the rounded features are held at 1e-3; the logits and
probs keep 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.runtime.classifier import yuv420_to_rgb as jax_yuv420_to_rgb
from stdd_torch.config import I3DConfig
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.runtime.classifier import ClipScorer, yuv420_to_rgb

from torch_port_helpers import jax_i3d_variables, max_rel_err

CFG = dict(num_frames=4, crop_size=64, width_per_group=8)
P_TOL = 1e-4
FORMATS = ["rgb", "yuv420"]
S = 96
ROUNDED_TOL = 1e-3


def _pair(variables, cfg=CFG, **kw):
    """The JAX scorer (gather warp) and the port's over ``variables``, with
    the same options."""
    js = JaxClipScorer(variables, cfg=JaxI3DConfig(**cfg), dtype=jnp.float32,
                       use_pallas_warp=False, **kw)
    ts = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**cfg), dtype=torch.float32,
                                        device="cpu", **kw)
    return js, ts


@pytest.fixture(scope="module")
def variables():
    return jax_i3d_variables(JaxI3DConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def rounded(variables):
    return {fmt: _pair(variables, round_aligned_u8=True, upload_format=fmt) for fmt in FORMATS}


def _batch(rng, fmt, B=3, T=4):
    """Clips of a face rotated by up to 20°, the last slot padding."""
    shape = (B, T, S * 3 // 2, S) if fmt == "yuv420" else (B, T, S, S, 3)
    crops = rng.randint(0, 256, shape, np.uint8)
    base = STD_POINTS_256 * (80 / 256.0) + 8.0
    ctr = base.mean(0)
    boxes = np.zeros((B, T, 4), np.float32)
    lm5 = np.zeros((B, T, 5, 2), np.float32)
    for b in range(B):
        a = np.radians(rng.uniform(-20, 20))
        rot = (base - ctr) @ np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]]) + ctr
        xy = 200.0 + np.cumsum(rng.uniform(-2, 2, (T, 2)), 0)
        boxes[b, :, :2], boxes[b, :, 2:] = xy, xy + S
        lm5[b] = rot + rng.normal(0, 0.5, (T, 5, 2))
    return crops, boxes, lm5, np.arange(B) < B - 1


@pytest.mark.parametrize("fmt", FORMATS)
def test_round_aligned_u8_matches_jax_through_every_entry_point(rounded, fmt):
    """``score``, ``score_windows`` with a scale fold, ``score_with_features``
    (logits and features too) and ``score_dense``. The rounding moves the
    probs more than the two scorers differ."""
    js, ts = rounded[fmt]
    rng = np.random.RandomState(1)
    crops, boxes, lm5, valid = _batch(rng, fmt)
    got = ts.score(crops, boxes, lm5, valid)
    want = js.score(crops, boxes, lm5, valid)
    np.testing.assert_allclose(got, want, atol=P_TOL, rtol=0)
    unrounded = ClipScorer(ts.model.state_dict(), cfg=ts.cfg, dtype=torch.float32,
                           upload_format=fmt, device="cpu")
    assert np.abs(got - unrounded.score(crops, boxes, lm5, valid)).max() > \
        3 * np.abs(got - want).max()

    scale = rng.uniform(0.7, 1.0, boxes.shape[:2]).astype(np.float32)
    got = np.asarray(ts.score_windows([torch.from_numpy(c) for c in crops], boxes, lm5, scale,
                                      valid))
    want = np.asarray(js.score_windows([jnp.asarray(c) for c in crops], boxes, lm5, scale,
                                       valid))
    np.testing.assert_allclose(got, want, atol=P_TOL, rtol=0)

    got = ts.score_with_features(crops, boxes, lm5, valid)
    want = js.score_with_features(crops, boxes, lm5, valid)
    np.testing.assert_allclose(got[0], want[0], atol=P_TOL, rtol=0)
    assert got[1].shape == want[1].shape and max_rel_err(got[1], want[1]) <= P_TOL
    assert got[2].shape == want[2].shape and max_rel_err(got[2], want[2]) <= ROUNDED_TOL

    n = 7
    frames = crops[0, np.arange(n) % 4]
    tb = boxes[0, np.arange(n) % 4] + np.arange(n, dtype=np.float32)[:, None]
    tl = lm5[0, np.arange(n) % 4]
    starts = np.array([0, 1, 3, 2])
    got = ts.score_dense(frames, tb, tl, starts, batch=3)
    want = js.score_dense(frames, tb, tl, starts, batch=3)
    np.testing.assert_allclose(got, want, atol=P_TOL, rtol=0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_the_model_sees_the_rounded_clip(rounded, fmt):
    """What reaches the I3D is the aligned clip rounded half to even and
    normalized: integers in [0, 255], the port's aligned clip rounded, and
    within one grey level of JAX's rounded clip (its ``_align_batch``, then
    its rounding, ``stdd_tpu/runtime/classifier.py:357-358``) on the values
    at a half (≤ 1%)."""
    js, ts = rounded[fmt]
    crops, boxes, lm5, valid = _batch(np.random.RandomState(1), fmt)
    seen = []
    hook = ts.model.register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
    try:
        ts.score(crops, boxes, lm5, valid)
    finally:
        hook.remove()
    got = (seen[0] * ts._std + ts._mean).numpy()
    assert np.abs(got - np.round(got)).max() <= 1e-3
    rgb = torch.from_numpy(crops)
    rgb = rgb.float() if fmt == "rgb" else yuv420_to_rgb(rgb)
    raw = ts._align_batch(rgb, torch.from_numpy(boxes), torch.from_numpy(lm5)).numpy()
    assert np.abs(raw - np.round(raw)).max() > 0.25               # the check can fail
    np.testing.assert_array_equal(np.round(got), np.round(np.clip(raw, 0, 255)))
    jrgb = jnp.asarray(crops) if fmt == "rgb" else jax_yuv420_to_rgb(jnp.asarray(crops))
    aligned = js._align_batch(jrgb, jnp.asarray(boxes), jnp.asarray(lm5), jnp.asarray(valid))
    want = np.round(np.clip(np.asarray(aligned), 0, 255))
    d = np.abs(np.round(got) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_score_index_selects_the_logit_as_jax_does():
    """A two-class head: ``score_index=1`` scores the second logit, as JAX's
    scorer does; features keep every column. An index outside [-C, C)
    raises here; JAX's indexing clamps it to the last class silently (a
    reference fault the port does not copy)."""
    cfg = dict(CFG, num_classes=2)
    variables = jax_i3d_variables(JaxI3DConfig(**cfg), seed=1)
    js, ts = _pair(variables, cfg, score_index=1)
    crops, boxes, lm5, valid = _batch(np.random.RandomState(2), "rgb")
    got = ts.score(crops, boxes, lm5, valid)
    np.testing.assert_allclose(got, js.score(crops, boxes, lm5, valid), atol=P_TOL, rtol=0)
    probs, logits, _ = ts.score_with_features(crops, boxes, lm5, valid)
    assert logits.shape == (3, 2)
    np.testing.assert_allclose(probs, np.where(valid, 1 / (1 + np.exp(-logits[:, 1])), 0),
                               atol=1e-6, rtol=0)
    assert np.abs(logits[valid, 0] - logits[valid, 1]).max() > 1e-3
    for bad in (2, -3):
        with pytest.raises(ValueError, match="score_index"):
            ClipScorer(ts.model.state_dict(), cfg=ts.cfg, dtype=torch.float32, device="cpu",
                       score_index=bad)
    clamped = JaxClipScorer(variables, cfg=JaxI3DConfig(**cfg), dtype=jnp.float32,
                            use_pallas_warp=False, score_index=7)
    np.testing.assert_array_equal(clamped.score(crops, boxes, lm5, valid),
                                  js.score(crops, boxes, lm5, valid))


def test_jax_stem_and_warp_flags_match_the_plain_port_scorer(variables):
    """JAX's ``s2d_stem=True`` (with ``stem_t2`` at an even frame count) is
    an exact re-layout of the stem, and ``warp_band`` only sizes its banded
    warp: the port's scorer, which computes the plain stem convolution and
    warps every clip with K1, matches JAX's with them set. The port takes
    none of the three: a caller that passes one gets a ``TypeError``."""
    js = JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                       use_pallas_warp=False, warp_band=32, s2d_stem=True)
    assert (js.cfg.s2d_stem, js.cfg.stem_t2) == (True, True)
    ts = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                        device="cpu")
    crops, boxes, lm5, valid = _batch(np.random.RandomState(3), "rgb")
    np.testing.assert_allclose(ts.score(crops, boxes, lm5, valid),
                               js.score(crops, boxes, lm5, valid), atol=P_TOL, rtol=0)
    for kw in (dict(s2d_stem=True), dict(use_pallas_warp=False), dict(warp_band=32)):
        with pytest.raises(TypeError):
            ClipScorer(ts.model.state_dict(), cfg=ts.cfg, dtype=torch.float32, device="cpu", **kw)
