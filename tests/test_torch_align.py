"""The port's alignment math, I420 codec and the K1 wrapper against JAX.

Tolerances (float32, pixel values on the 0..255 scale):

- similarity solve, ``pack_warp_params``, ``yuv420_to_rgb``: max |Δ| ≤ 1e-4
  · max(1, max |reference|);
- the plain warp against JAX ``warp_clip_bilinear``: ≤ 1e-4 where both
  sides compute the same sample coordinates (affines whose inverse is exact
  in float32), on sharp random texture. For arbitrary affines the two
  frameworks invert the 2×3 matrix differently (closed form vs LU), which
  moves a coordinate by a few float32 ulps; on a smooth crop that vanishes
  at its border (|gradient| ≤ 1.9 grey levels per pixel) that stays ≤ 1e-3
  (observed: 2.4e-4 at ±45°);
- the plain warp against the Pallas kernel in interpret mode, inside its
  rotation envelope: ≤ 0.26 grey levels where a sample lies within 0.001 of
  the crop's edge (the Pallas kernel zeroes coordinates with x < −0.999 or
  x > W − 0.001, where the gather keeps a weight ≤ 0.001 of a 255 tap), and
  ≤ 5e-3 elsewhere (the kernel's hat weights 1 − |x − j| round a coordinate
  differently from x − floor(x), by a few ulps times a 255 step);
- the numpy I420 encoder against cv2: exact.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.ops import align as jalign
from stdd_tpu.ops.warp_pallas import pack_warp_params as jax_pack
from stdd_tpu.ops.warp_pallas import rotation_fits_band, warp_clip_pallas
from stdd_tpu.runtime.classifier import yuv420_to_rgb as jax_yuv420_to_rgb
from stdd_torch.ops import align as talign
from stdd_torch.ops.warp import pack_warp_params, warp_affine, warp_affine_reference
from stdd_torch.runtime.classifier import yuv420_to_rgb
from stdd_torch.runtime.packing import rgb_to_i420

from torch_port_helpers import max_rel_err

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clip_landmarks(rng, B, T, max_deg, scale=1.0):
    """[B, T, 4] big boxes and [B, T, 5, 2] crop-local landmarks of a face
    rotated by up to ``max_deg`` and drifting a little across the clip."""
    boxes = np.zeros((B, T, 4), np.float32)
    lm5 = np.zeros((B, T, 5, 2), np.float32)
    base = jalign.STD_POINTS_256 * 0.35 * scale + 12.0
    ctr = base.mean(0)
    for b in range(B):
        ang = np.radians(rng.uniform(-max_deg, max_deg))
        c, s = np.cos(ang), np.sin(ang)
        rot = (base - ctr) @ np.array([[c, s], [-s, c]]) + ctr
        xy = rng.uniform(0, 30, (T, 2))
        boxes[b, :, :2] = xy
        boxes[b, :, 2:] = xy + 100
        lm5[b] = rot[None] + rng.normal(0, 0.7, (T, 5, 2))
    return boxes, lm5


@pytest.mark.parametrize("max_deg", [0.0, 15.0, 45.0])
def test_similarity_solve_matches_jax(max_deg):
    rng = np.random.RandomState(int(max_deg))
    B, T, S = 3, 6, 64
    boxes, lm5 = _clip_landmarks(rng, B, T, max_deg)
    diffs, pts = talign.clip_geometry(_t(boxes), _t(lm5))
    tfm, trans = talign.similarity_cv2(pts.flatten(-3, -2), talign.std_points(S, "cpu").repeat(T, 1))
    assert tfm.shape == (B, 2, 3) and trans.shape == (B, 3, 3)
    for b in range(B):
        d = boxes[b, :, :2] - boxes[b, :, :2].min(0)
        np.testing.assert_array_equal(diffs[b].numpy(), d)
        jt, jtr = jalign.similarity_cv2(jnp.asarray((lm5[b] + d[:, None]).reshape(-1, 2)),
                                        jnp.tile(jalign.std_points(S), (T, 1)))
        assert max_rel_err(tfm[b], jt) <= TOL
        assert max_rel_err(trans[b], jtr) <= TOL


def test_reflective_candidate_matches_jax():
    """A mirrored point set makes the reflective candidate win; the
    selection (and the reference's aliasing quirk) follows JAX."""
    rng = np.random.RandomState(5)
    src = rng.uniform(0, 100, (2, 10, 2)).astype(np.float32)
    dst = src.copy()
    dst[1] = src[1] * np.array([-1.0, 1.0], np.float32) * 0.8 + 7.0   # mirrored clip
    dst += rng.normal(0, 0.5, dst.shape).astype(np.float32)
    got = talign.find_similarity(_t(src), _t(dst))
    got_nr = talign.find_similarity(_t(src), _t(dst), reflective=False)
    for b in range(2):
        want = np.asarray(jalign.find_similarity(jnp.asarray(src[b]), jnp.asarray(dst[b])))
        assert max_rel_err(got[b], want) <= TOL
    # the two clips took different candidates
    assert np.allclose(got[0], got_nr[0]) != np.allclose(got[1], got_nr[1])


def test_pack_warp_params_matches_jax():
    rng = np.random.RandomState(2)
    B, T, S = 3, 6, 64
    boxes, lm5 = _clip_landmarks(rng, B, T, 45.0)
    diffs, pts = talign.clip_geometry(_t(boxes), _t(lm5))
    tfm, _ = talign.similarity_cv2(pts.flatten(-3, -2), talign.std_points(S, "cpu").repeat(T, 1))
    params = pack_warp_params(tfm, diffs)
    assert params.shape == (B, T, 8) and params.dtype == torch.float32
    for b in range(B):
        want = np.asarray(jax_pack(jnp.asarray(tfm[b].numpy()), jnp.asarray(diffs[b].numpy())))
        assert max_rel_err(params[b], want) <= TOL


def test_yuv420_to_rgb_matches_jax():
    planar = np.random.RandomState(0).randint(0, 256, (2, 3, 96, 64), np.uint8)
    got = yuv420_to_rgb(_t(planar))
    want = np.asarray(jax_yuv420_to_rgb(jnp.asarray(planar)))
    assert got.shape == want.shape == (2, 3, 64, 64, 3)
    assert max_rel_err(got, want) <= TOL


def _exact_affines(rng, T):
    """Forward affines whose inverse (dst→src) is dyadic, so both
    frameworks invert them exactly: 0°/±45° rotations at scales 1/√2, 1
    and 2, translations in eighths."""
    lin = [np.array([[0.5, 0.5], [-0.5, 0.5]]), np.array([[0.5, -0.5], [0.5, 0.5]]),
           np.eye(2), np.eye(2) * 0.5, np.array([[1.0, 1.0], [-1.0, 1.0]])]
    out = []
    for i in range(T):
        L = lin[i % len(lin)]
        t = rng.randint(-160, 480, 2) / 8.0
        A = np.linalg.inv(L)
        out.append(np.concatenate([A, -(A @ t)[:, None]], 1).astype(np.float32))
    return out


def test_plain_warp_matches_jax_gather_exact_coordinates():
    """Sharp random texture, scale folds, out-of-image taps: the torch
    gather equals the JAX gather where the coordinates agree."""
    rng = np.random.RandomState(7)
    T, H, W, S = 5, 40, 44, 48
    crops = rng.randint(0, 256, (T, H, W, 3), np.uint8)
    diffs = rng.randint(0, 6, (T, 2)).astype(np.float32)
    scales = np.array([1.0, 0.75, 0.5, 1.0, 0.625], np.float32)
    for tfm in _exact_affines(rng, 5):
        np.testing.assert_array_equal(talign.invert_affine_2x3(_t(tfm)).numpy(),
                                      np.asarray(jalign.invert_affine_2x3(jnp.asarray(tfm))))
        want = np.asarray(jalign.warp_clip_bilinear(jnp.asarray(crops), jnp.asarray(tfm),
                                                    jnp.asarray(diffs), S, scales=jnp.asarray(scales)))
        got = talign.warp_clip_bilinear(_t(crops), _t(tfm), _t(diffs), S, scales=_t(scales))
        assert (want == 0).mean() > 0.05        # some taps fall outside the crop
        assert np.abs(got.numpy() - want).max() <= TOL
        # the packed form the scorer feeds K1 gives the same image
        params = pack_warp_params(_t(tfm), _t(diffs)) * _t(scales)[:, None]
        flat = warp_affine(_t(crops), params.contiguous(), S)
        assert np.abs(flat.numpy() - want).max() <= TOL


def _smooth_crops(T, H, W):
    """Per-channel sine bumps that vanish at the crop's border, so the
    zero-extended image is continuous (|gradient| ≤ 1.9 per pixel)."""
    y = np.sin(np.pi * (np.arange(H) + 1) / (H + 1))[:, None]
    x = np.sin(np.pi * (np.arange(W) + 1) / (W + 1))[None, :]
    base = (y * x)[None, :, :, None]
    amp = np.array([60.0, 45.0, 30.0])[None, None, None, :] * (1 + np.arange(T))[:, None, None, None] / T
    return (base * amp).astype(np.float32)


@pytest.mark.parametrize("max_deg", [10.0, 45.0])
def test_align_clip_matches_jax(max_deg):
    """The whole clip alignment (similarity solve + per-frame scale fold +
    gather) for rotations up to ±45°, against JAX ``align_clip``."""
    rng = np.random.RandomState(11)
    B, T, H, W, S = 2, 4, 96, 100, 64
    boxes, lm5 = _clip_landmarks(rng, B, T, max_deg)
    crops = np.stack([_smooth_crops(T, H, W)] * B)
    scales = rng.uniform(0.5, 1.0, (B, T)).astype(np.float32)
    aligned, lm5_t, _, tfm = talign.align_clip(
        _t(crops), _t(boxes), _t(lm5), out_size=S, template=talign.std_points(S, "cpu"),
        scales=_t(scales))
    assert aligned.shape == (B, T, S, S, 3)
    for b in range(B):
        ja, jl, _, jt = jalign.align_clip(jnp.asarray(crops[b]), jnp.asarray(boxes[b]),
                                          jnp.asarray(lm5[b]), out_size=S,
                                          scales=jnp.asarray(scales[b]))
        assert max_rel_err(tfm[b], jt) <= TOL
        assert max_rel_err(lm5_t[b], jl) <= TOL
        assert float(np.abs(np.asarray(ja)).max()) > 10.0
        assert np.abs(aligned[b].numpy() - np.asarray(ja)).max() <= 1e-3


def test_padded_slots_give_nonfinite_params_and_zero_pixels():
    """All-zero landmarks (padded batch slots) fit to sc = ss = 0: the
    closed-form inverses give non-finite parameters, as ``jnp.linalg.inv``
    does, and raise nothing; the warp of such a row is exactly 0."""
    T, S = 4, 32
    boxes = torch.zeros(2, T, 4)
    lm5 = torch.zeros(2, T, 5, 2)
    lm5[0] = _t(jalign.STD_POINTS_256.astype(np.float32) * 0.2)        # one live clip
    diffs, pts = talign.clip_geometry(boxes, lm5)
    tfm, _ = talign.similarity_cv2(pts.flatten(-3, -2), talign.std_points(S, "cpu").repeat(T, 1))
    params = pack_warp_params(tfm, diffs)
    assert torch.isfinite(params[0]).all()
    assert not torch.isfinite(params[1, :, :6]).any()
    jt, _ = jalign.similarity_cv2(jnp.zeros((T * 5, 2)), jnp.tile(jalign.std_points(S), (T, 1)))
    assert not np.isfinite(np.asarray(jax_pack(jt, jnp.zeros((T, 2))))[:, :6]).any()
    crops = torch.full((2 * T, 16, 16, 3), 200, dtype=torch.uint8)
    out = warp_affine(crops, params.reshape(2 * T, 8).contiguous(), S)
    assert torch.isfinite(out).all()
    assert float(out[T:].abs().max()) == 0.0
    assert float(out[:T].max()) > 0.0


def test_plain_warp_nonfinite_and_huge_coordinates_sample_nothing():
    crops = torch.full((5, 8, 8, 3), 255, dtype=torch.uint8)
    params = torch.zeros(5, 8)
    params[:, 0] = params[:, 4] = 1.0                   # identity
    params[0, 2] = float("nan")
    params[1, 4] = float("inf")
    params[2, 5] = 1e30
    params[3, 2] = -1e30
    out = warp_affine_reference(crops, params, 6)
    assert float(out[:4].abs().max()) == 0.0
    assert float(out[4].min()) == 255.0


@pytest.mark.parametrize("H", [64, 60])
def test_plain_warp_matches_pallas_interpret_inside_band(H):
    """Inside the TPU kernel's rotation envelope (and for a crop height that
    is not a multiple of 8), K1's plain version agrees with the Pallas kernel
    run in interpret mode, within the border tolerance stated above."""
    rng = np.random.RandomState(H)
    N, W, S, band = 4, 72, 48, 32
    crops = rng.randint(0, 256, (N, H, W, 3), np.uint8)
    ang = np.radians(rng.uniform(-3, 3, N))
    s = rng.uniform(0.9, 1.3, N)
    c, sn = np.cos(ang) * s, np.sin(ang) * s
    params = np.zeros((N, 8), np.float32)
    params[:, 0], params[:, 1], params[:, 3], params[:, 4] = c, -sn, sn, c
    params[:, 2] = rng.uniform(-12, 36, N)              # some taps leave the crop
    params[:, 5] = rng.uniform(-12, 28, N)
    tfm = np.stack([np.linalg.inv(np.vstack([p[:6].reshape(2, 3), [0, 0, 1]]))[:2]
                    for p in params.astype(np.float64)])
    assert rotation_fits_band(tfm, S, band)
    want = np.asarray(warp_clip_pallas(jnp.asarray(crops), jnp.asarray(params), out_size=S,
                                       band=band, interpret=True))
    got = warp_affine(_t(crops), _t(params), S).numpy()
    r = np.arange(S, dtype=np.float32)
    x = params[:, 0, None, None] * r[None, None, :] + params[:, 1, None, None] * r[None, :, None] + params[:, 2, None, None]
    y = params[:, 3, None, None] * r[None, None, :] + params[:, 4, None, None] * r[None, :, None] + params[:, 5, None, None]
    edge = ((np.abs(x + 1) < 2e-3) | (np.abs(x - W) < 2e-3) | (np.abs(x - (W - 1)) < 2e-3)
            | (np.abs(y + 1) < 2e-3) | (np.abs(y - H) < 2e-3) | (np.abs(y - (H - 1)) < 2e-3))
    err = np.abs(got - want).max(-1)
    assert err.max() <= 0.26
    assert err[~edge].max() <= 5e-3
    assert (want == 0).mean() > 0.01


def test_i420_encoder_matches_cv2():
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (64, 64, 3), np.uint8),
            np.zeros((32, 32, 3), np.uint8), np.full((32, 32, 3), 255, np.uint8),
            np.tile(np.array([255, 0, 0], np.uint8), (16, 16, 1)),
            np.tile(np.array([0, 0, 255], np.uint8), (16, 16, 1))]
    for rgb in imgs:
        S = rgb.shape[0]
        out = np.empty((S * 3 // 2, S), np.uint8)
        rgb_to_i420(rgb, out)
        np.testing.assert_array_equal(out, cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420))


def test_warp_wrapper_routes_cpu_tensors_to_plain_version():
    rng = np.random.RandomState(1)
    crops = _t(rng.randint(0, 256, (3, 20, 24, 3), np.uint8))
    params = _t(rng.uniform(-1, 1, (3, 8)).astype(np.float32)
                * np.array([1, 1, 10, 1, 1, 10, 0, 0], np.float32))
    before = warp_affine.launches
    for c in (crops, crops.float()):
        out = warp_affine(c, params, 16)
        assert out.dtype == torch.float32 and out.shape == (3, 16, 16, 3)
        assert torch.equal(out, warp_affine_reference(c, params, 16))
    assert warp_affine.launches == before            # the kernel never ran
    bad = [(crops.double(), params), (crops, params.double()), (crops[:, :, :, :2], params),
           (crops, params[:2]), (crops, params.to("meta"))]
    for c, p in bad:
        with pytest.raises(ValueError):
            warp_affine(c, p, 16)
    assert warp_affine.launches == before


# -- the host side: warp_affine_u8 and align_clip_host ----------------------------
# ``warp_affine_u8`` reproduces OpenCV 5.0's float32 bilinear warp: equal to
# ``cv2.warpAffine`` (INTER_LINEAR) on all but fewer than 1 value in 10^4,
# and those one grey level off (a rounding tie broken the other way;
# measured 2.6e-5 with a constant and 8.2e-5 with a replicated border).

WARP_MISS_SHARE = 1e-4


def _random_affines(rng, n, shear):
    out = []
    for _ in range(n):
        h, w = rng.randint(20, 160, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ang, s = rng.uniform(-0.6, 0.6), rng.uniform(0.5, 2.0)
        M = np.array([[s * np.cos(ang), -s * np.sin(ang), rng.uniform(-30, 30)],
                      [s * np.sin(ang), s * np.cos(ang), rng.uniform(-30, 30)]])
        if shear:
            M[0, 1] += rng.uniform(-0.3, 0.3)
            M[1, 0] += rng.uniform(-0.3, 0.3)
        out.append((img, M, tuple(int(v) for v in rng.randint(20, 160, 2))))
    return out


@pytest.mark.parametrize("border", ["constant", "replicate"])
@pytest.mark.parametrize("shear", [False, True], ids=["similarity", "shear"])
def test_warp_affine_u8_matches_cv2(border, shear):
    mode = cv2.BORDER_CONSTANT if border == "constant" else cv2.BORDER_REPLICATE
    rng = np.random.RandomState(7 + shear)
    miss = total = 0
    for img, M, (oh, ow) in _random_affines(rng, 24, shear):
        want = cv2.warpAffine(img, M, (ow, oh), flags=cv2.INTER_LINEAR, borderMode=mode)
        got = talign.warp_affine_u8(img, M, (oh, ow), border=border)
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want)
        assert d.max() <= 1
        miss += int((d > 0).sum())
        total += d.size
    assert miss / total < WARP_MISS_SHARE, miss / total
    gray = rng.randint(0, 256, (30, 40)).astype(np.uint8)
    M = np.array([[1.1, 0.1, 2.0], [-0.1, 0.9, 3.0]])
    d = np.abs(talign.warp_affine_u8(gray, M, (25, 35)).astype(int)
               - cv2.warpAffine(gray, M, (35, 25)))
    assert d.max() <= 1
    np.testing.assert_array_equal(talign.warp_affine_u8(img, np.eye(2, 3), img.shape[:2]), img)
    with pytest.raises(ValueError, match="reflect"):
        talign.warp_affine_u8(img, M, (8, 8), border="reflect")


def test_align_clip_host_matches_jax():
    rng = np.random.RandomState(3)
    T = 8
    boxes = np.zeros((T, 4), np.float32)
    crops, lm5 = [], np.zeros((T, 5, 2), np.float32)
    base = jalign.STD_POINTS_256 * 0.4 + 20.0
    for t in range(T):
        xy = rng.uniform(100, 130, 2)
        hw = rng.randint(120, 140, 2)
        boxes[t] = [xy[0], xy[1], xy[0] + hw[1], xy[1] + hw[0]]
        crops.append(rng.randint(0, 256, (hw[0], hw[1], 3)).astype(np.uint8))
        lm5[t] = base + rng.normal(0, 1.0, (5, 2))
    np.testing.assert_array_equal(
        talign.find_similarity_np(lm5.reshape(-1, 2), np.tile(jalign.STD_POINTS_256, (T, 1))),
        jalign.find_similarity_np(lm5.reshape(-1, 2), np.tile(jalign.STD_POINTS_256, (T, 1))))
    want = jalign.align_clip_host(crops, boxes, lm5, out_size=112)
    got = talign.align_clip_host(crops, boxes, lm5, out_size=112)
    assert got.shape == want.shape == (T, 112, 112, 3)
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() < WARP_MISS_SHARE, (d.max(), (d > 0).mean())
