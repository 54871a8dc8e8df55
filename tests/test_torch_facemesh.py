"""The port's dense landmarker and face renderer against the JAX package
(``stdd_torch/models/facemesh.py`` vs ``stdd_tpu/models/facemesh.py``).

Tolerances (float32 on the CPU):
- canonical mesh, ``lm5_agreement``, the constants: equal;
- ``deform`` / ``reconstruct``: ≤ 1e-6;
- ``render_faces``: ≤ 1e-5 per pixel value in [0, 1] in float64 on both
  sides; ≤ 2.5e-4 in float32, where each package's render lies up to 2e-4
  from its own float64 render (see the test);
- ``LandmarkNet`` with the packaged weights: ≤ 1e-5 on (rigid, theta) — a
  symmetric (1, 1) padding of the stride-2 convs or the exact GELU would
  miss this by orders of magnitude;
- ``DenseLandmarker`` on a frame: ≤ 0.5 px; its crop resize is cv2's
  INTER_LINEAR grid in float32, one grey level from ``cv2.resize`` on some
  pixels.
The draws of ``sample_params`` / ``augment_renders`` are torch's, so only
their ranges, held-out bands and label preservation are compared.
"""

import hashlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stdd_tpu.models.facemesh as J
from stdd_torch.data.features import MP68_IDX
from stdd_torch.models import facemesh as T
from stdd_torch.utils.weights import flax_to_torch, torch_to_flax

SHA = "6ef2388d202d12e558a3decda4b989d7c67689dc28dca9f511f0ece964a7648e"
jax_render = jax.jit(J.render_faces, static_argnames=("size",))


def _params(B, seed=0):
    rng = np.random.RandomState(seed)
    rigid = np.c_[rng.uniform(-0.45, 0.25, B), rng.uniform(-0.5, 0.5, B),
                  rng.uniform(-0.1, 0.1, (B, 2))].astype(np.float32)
    theta = np.c_[rng.rand(B, 2) ** 2, rng.uniform(-1, 1, (B, 2)), rng.rand(B),
                  rng.uniform(-1, 1, B)].astype(np.float32)
    style = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    return rigid, theta, style


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def packaged():
    with open(T.DenseLandmarker.pretrained_path(), "rb") as f:
        return pickle.load(f)


def test_constants_canonical_mesh_and_lm5_agreement_equal():
    assert (T.N_POINTS, T.THETA_DIM, T.RIGID_DIM) == (J.N_POINTS, J.THETA_DIM, J.RIGID_DIM)
    assert T.LM5_DENSE_IDX == J.LM5_DENSE_IDX
    assert T.LM5_AGREEMENT_BOUND == J.LM5_AGREEMENT_BOUND
    assert (T.HOLDOUT_ROT, T.HOLDOUT_LIGHT) == (J.HOLDOUT_ROT, J.HOLDOUT_LIGHT)
    np.testing.assert_array_equal(T.canonical_mesh(), J.canonical_mesh())
    rng = np.random.RandomState(0)
    for _ in range(5):
        pts = rng.uniform(0, 100, (478, 2)).astype(np.float32)
        lm5 = rng.uniform(0, 100, (5, 2)).astype(np.float32)
        w = float(rng.uniform(10, 90))
        assert T.lm5_agreement(pts, lm5, w) == J.lm5_agreement(pts, lm5, w)


def test_deform_apply_rigid_reconstruct_match_jax():
    rigid, theta, _ = _params(7)
    canon = T.canonical_mesh()
    tc, tr, tt = _t(canon, rigid, theta)
    np.testing.assert_allclose(
        T.deform(tc, tt).numpy(), np.asarray(J.deform(jnp.asarray(canon), jnp.asarray(theta))),
        atol=1e-6)
    np.testing.assert_allclose(
        T.reconstruct(tc, tr, tt).numpy(),
        np.asarray(J.reconstruct(jnp.asarray(canon), jnp.asarray(rigid), jnp.asarray(theta))),
        atol=1e-6)


@pytest.mark.parametrize("size", [64, 128])
def test_render_faces_matches_jax(size):
    """Float64 on both sides: ≤ 1e-5 (measured 2e-13). Float32: ≤ 2.5e-4.
    The renderer's sharp edges (a sigmoid of slope up to 1/0.006 over an
    ellipse distance) turn float32 rounding of the coordinates into up to
    2e-4 of a pixel value — each package's float32 render lies that far
    from its own float64 render — so two float32 programs that order their
    roundings differently cannot agree to 1e-5."""
    rigid, theta, style = _params(6, seed=size)
    with jax.enable_x64(True):
        want64 = np.asarray(jax_render(*[jnp.asarray(a, jnp.float64)
                                             for a in (rigid, theta, style)], size=size))
    got64 = T.render_faces(*[t.double() for t in _t(rigid, theta, style)], size=size).numpy()
    assert got64.dtype == want64.dtype == np.float64
    np.testing.assert_allclose(got64, want64, atol=1e-5)
    want = np.asarray(jax_render(jnp.asarray(rigid), jnp.asarray(theta),
                                 jnp.asarray(style), size=size))
    got = T.render_faces(*_t(rigid, theta, style), size=size).numpy()
    assert got.shape == want.shape == (6, size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2.5e-4)
    one = T.render_one(*_t(rigid[0], theta[0], style[0]), size=size).numpy()
    np.testing.assert_allclose(one, got[0], atol=1e-6)


def test_render_noise_is_drawn_from_the_generator():
    rigid, theta, style = _t(*_params(2))
    clean = T.render_faces(rigid, theta, style, size=32)
    a = T.render_faces(rigid, theta, style, generator=torch.Generator().manual_seed(1), size=32)
    b = T.render_faces(rigid, theta, style, generator=torch.Generator().manual_seed(1), size=32)
    assert torch.equal(a, b) and 0.01 < float((a - clean).abs().mean()) < 0.05
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_landmarknet_with_packaged_weights_matches_jax(packaged):
    rigid, theta, style = _params(5, seed=3)
    imgs = np.asarray(jax_render(jnp.asarray(rigid), jnp.asarray(theta), jnp.asarray(style)))
    jr, jt = jax.jit(J.LandmarkNet().apply)(jax.tree_util.tree_map(jnp.asarray, packaged),
                                   jnp.asarray(imgs))
    net = T.LandmarkNet()
    net.load_state_dict(flax_to_torch(packaged, net, "landmarker"))
    with torch.no_grad():
        tr, tt = net(*_t(imgs))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_same_padding_pads_after_on_a_stride_two_even_side():
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    y = T._same_pad(x, 3, 2)
    assert y.shape == (1, 1, 5, 5)
    assert torch.equal(y[..., :4, :4], x) and float(y[..., 4, :].abs().sum()) == 0.0
    assert T._same_pad(x, 3, 1).shape == (1, 1, 6, 6)


def test_bridge_round_trip_and_refusals(packaged):
    net = T.LandmarkNet()
    sd = flax_to_torch(packaged, net, "landmarker")
    back = torch_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(packaged)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(packaged)):
        np.testing.assert_array_equal(a, b)
    extra = {"params": dict(packaged["params"], stray={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(ValueError, match="stray"):
        flax_to_torch(extra, net, "landmarker")
    missing = {"params": {k: v for k, v in packaged["params"].items() if k != "head"}}
    with pytest.raises(ValueError, match="missing"):
        flax_to_torch(missing, net, "landmarker")


def test_packaged_checkpoint_is_the_jax_packages_bytes():
    path = T.DenseLandmarker.pretrained_path()
    assert path.endswith(os.path.join("stdd_torch", "assets", "landmarker.pkl"))
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    # the digest tests/test_facemesh.py::test_pretrained_checkpoint_provenance_checksum pins
    assert digest == SHA, digest
    with open(J.DenseLandmarker.pretrained_path(), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == digest


def _face_frame():
    rigid, theta, style = _params(1, seed=9)
    rigid[0] = (-0.1, 0.1, 0.02, -0.03)
    tile = np.asarray(jax_render(jnp.asarray(rigid), jnp.asarray(theta), jnp.asarray(style)))
    sprite = (np.repeat(np.repeat(tile[0], 2, 0), 2, 1) * 255).astype(np.uint8)   # 256 px
    frame = np.full((320, 400, 3), 90, np.uint8)
    frame[30:286, 70:326] = sprite
    return frame, (95.0, 60.0, 300.0, 270.0)


def test_dense_landmarker_on_a_frame_matches_jax(packaged):
    frame, box = _face_frame()
    want = J.DenseLandmarker(variables=jax.tree_util.tree_map(jnp.asarray, packaged))(frame, box)
    lm = T.DenseLandmarker(variables=packaged, device="cpu")
    got = lm(frame, box)
    assert got.shape == (478, 2) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.5, np.abs(got - want).max()
    np.testing.assert_array_equal(lm.lm68(frame, box), got[MP68_IDX])


def test_save_load_crosses_both_packages(tmp_path, packaged):
    frame, box = _face_frame()
    lm = T.DenseLandmarker(variables=packaged, device="cpu")
    p = str(tmp_path / "lm.pkl")
    lm.save(p)
    got = T.DenseLandmarker.from_checkpoint(p, device="cpu")(frame, box)
    np.testing.assert_array_equal(got, lm(frame, box))
    jl = J.DenseLandmarker.from_checkpoint(p)
    np.testing.assert_allclose(jl(frame, box), got, atol=0.5)
    fresh = T.DenseLandmarker(seed=3, device="cpu")
    w = fresh.net.c1.weight.detach()
    # flax's lecun_normal: variance 1/fan_in; biases zero
    assert abs(float(w.std()) * np.sqrt(32 * 9) - 1.0) < 0.1
    assert float(fresh.net.c1.bias.detach().abs().sum()) == 0


def test_sample_params_ranges_and_holdout_bands():
    g = torch.Generator().manual_seed(0)
    rigid, theta, style = T.sample_params(g, 4000)
    r, t, s = rigid.numpy(), theta.numpy(), style.numpy()
    assert r.shape == (4000, 4) and t.shape == (4000, 6) and s.shape == (4000, 8)
    for col, lo, hi in [(0, -0.45, 0.25), (1, -0.5, 0.5), (2, -0.1, 0.1), (3, -0.1, 0.1)]:
        assert lo <= r[:, col].min() < lo + 0.02 and hi - 0.02 < r[:, col].max() <= hi
    assert 0 <= t[:, :2].min() and t[:, :2].max() <= 1 and t[:, :2].mean() < 0.4   # u², mostly open
    assert -1 <= t[:, 2:4].min() and t[:, 2:4].max() <= 1
    assert 0 <= t[:, 4].min() and t[:, 4].max() <= 1 and -1 <= t[:, 5].min() and t[:, 5].max() <= 1
    assert -1 <= s.min() and s.max() <= 1
    assert (r[:, 1] > T.HOLDOUT_ROT[0]).any() and (s[:, 6] > T.HOLDOUT_LIGHT[0]).any()
    r2, _, s2 = [a.numpy() for a in T.sample_params(g, 4000, exclude_holdout=True)]
    assert r2[:, 1].max() < T.HOLDOUT_ROT[0] and s2[:, 6].max() < T.HOLDOUT_LIGHT[0]
    r3, _, s3 = [a.numpy() for a in T.sample_holdout_params(g, 500)]
    assert (T.HOLDOUT_ROT[0] <= r3[:, 1]).all() and (r3[:, 1] <= T.HOLDOUT_ROT[1]).all()
    assert (T.HOLDOUT_LIGHT[0] <= s3[:, 6]).all() and (s3[:, 6] <= T.HOLDOUT_LIGHT[1]).all()
    a = T.sample_params(torch.Generator().manual_seed(5), 3)
    b = T.sample_params(torch.Generator().manual_seed(5), 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_augment_renders_preserves_labels_and_varies_pixels():
    g = torch.Generator().manual_seed(0)
    rigid, theta, style = T.sample_params(g, 8)
    canon = torch.from_numpy(T.canonical_mesh())
    gt = T.reconstruct(canon, rigid, theta).clone()
    base = T.render_faces(rigid, theta, style, size=64)
    aug = T.augment_renders(torch.Generator().manual_seed(1), base)
    assert aug.shape == base.shape and float(aug.min()) >= 0 and float(aug.max()) <= 1
    assert ((aug - base).abs().mean(dim=(1, 2, 3)) > 0.01).all()
    aug2 = T.augment_renders(torch.Generator().manual_seed(2), base)
    assert float((aug2 - aug).abs().mean()) > 0.005
    # the labels are a function of the parameters alone, which augmenting
    # leaves untouched
    assert torch.equal(T.reconstruct(canon, rigid, theta), gt)
