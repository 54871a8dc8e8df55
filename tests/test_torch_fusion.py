"""The port's RGB fusion (``stdd_torch/models/dual_rgb.py``,
``stdd_torch/train/engine_fusion.py``) and its weight bridges
(``stdd_torch/utils/weights.py``) against the JAX package's.

Geometry: ``DualEncoderRGB`` at AU 6, landmarks 10, RGB features 64,
d_model 32, one layer, two heads, T 6, batch 4 (one all-pad row); the
``GatedMoE`` at its shipped hidden width of 8 over 24 videos. The weights
are the JAX models' own initializers, carried to the port by the bridges.
Tolerances: the float32 forwards within 1e-5 · max(1, max |JAX|)
(``test_torch_dual_model.py``'s ``TOL``); ``train_moe``'s 200 full-batch
Adam steps in float32 on both sides, fused probs, gates and parameters
within 1e-5 of JAX's on the same scale; the AUCs within 1e-12 of
scikit-learn's; ``align_scores`` exact.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.models import dual_rgb as jrgb
from stdd_tpu.train import engine_fusion as jfusion
from stdd_torch.models import dual_rgb as prgb
from stdd_torch.train import engine_fusion as pfusion
from stdd_torch.utils.weights import (dual_flax_to_torch, dual_torch_to_flax, moe_flax_to_torch,
                                      moe_torch_to_flax)

from torch_port_helpers import max_rel_err

KW = dict(au_dim=6, lmk_dim=10, vis_dim=64, d_model=32, depth=1, heads=2)
B, T = 4, 6
TOL = 1e-5
LENGTHS = np.array([6, 4, 1, 0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def rgb_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(B, T, 6).astype(np.float32), rng.randn(B, T, 10).astype(np.float32),
            rng.randn(B, T, 64).astype(np.float32))


@pytest.fixture(scope="module")
def rgb_variables(rgb_inputs):
    model = jrgb.DualEncoderRGB(**KW)
    init = jax.jit(lambda key, A, L, R: model.init(key, A, L, R, lengths=jnp.asarray(LENGTHS)))
    return tree_np(init(jax.random.PRNGKey(0), *rgb_inputs))


@pytest.fixture(scope="module")
def moe_data():
    rng = np.random.RandomState(1)
    y = (np.arange(24) % 2).astype(np.float32)
    z_rgb = (rng.randn(24) + 1.2 * (2 * y - 1)).astype(np.float32)
    z_dual = (rng.randn(24) * 2 + 0.8 * (2 * y - 1)).astype(np.float32)
    return z_rgb, z_dual, y


def test_masked_mean_matches_jax():
    z = np.random.RandomState(2).randn(3, 5, 4).astype(np.float32)
    pad = np.array([[False, False, True, True, True], [False] * 5, [True] * 5])
    for mask in (pad, None):
        got = prgb.masked_mean(torch.from_numpy(z), None if mask is None else torch.from_numpy(mask))
        want = jrgb.masked_mean(jnp.asarray(z), None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[2] if mask is not None else 0, 0)
    all_pad = prgb.masked_mean(torch.from_numpy(z), torch.from_numpy(pad))[2]
    assert torch.equal(all_pad, torch.zeros(4))               # clamped weights, no NaN


@pytest.mark.parametrize("lengths", [LENGTHS, None], ids=["lengths", "no_mask"])
def test_dual_encoder_rgb_forward_matches_jax(rgb_inputs, rgb_variables, lengths):
    model = prgb.DualEncoderRGB(**KW)
    model.load_state_dict(dual_flax_to_torch(rgb_variables["params"], model))
    jl = None if lengths is None else jnp.asarray(lengths)
    want = jax.jit(jrgb.DualEncoderRGB(**KW).apply)(rgb_variables, *rgb_inputs, lengths=jl)
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in rgb_inputs),
                    lengths=None if lengths is None else torch.from_numpy(lengths))
    for k in ("bin_logits", "z"):
        assert got[k].shape == want[k].shape
        assert max_rel_err(got[k].numpy(), want[k]) <= TOL, k


def test_dual_encoder_rgb_freezes_the_rgb_branch(rgb_inputs, rgb_variables):
    """No gradient reaches ``rgb_proj`` or the features (JAX's two
    ``stop_gradient``s); the trainable branches get one; dropout in
    training keeps the shapes."""
    model = prgb.DualEncoderRGB(**KW)
    model.load_state_dict(dual_flax_to_torch(rgb_variables["params"], model))
    A, L, R = (torch.from_numpy(x) for x in rgb_inputs)
    R.requires_grad_(True)
    out = model(A, L, R, lengths=torch.from_numpy(LENGTHS), train=True,
                generator=torch.Generator().manual_seed(0))
    (out["bin_logits"] ** 2).sum().backward()
    assert out["bin_logits"].shape == (B,) and out["z"].shape == (B, 3 * 32)
    assert model.rgb_proj.weight.grad is None and not model.rgb_proj.weight.requires_grad
    assert R.grad is None
    assert float(model.au_enc.proj.weight.grad.abs().max()) > 0
    assert float(model.head_fc1.weight.grad.abs().max()) > 0


def test_gated_moe_forward_matches_jax(moe_data):
    z_rgb, z_dual, _ = moe_data
    zr, zd = z_rgb[:, None], z_dual[:, None]
    variables = tree_np(jrgb.GatedMoE().init(jax.random.PRNGKey(3), zr, zd))
    model = prgb.GatedMoE()
    model.load_state_dict(moe_flax_to_torch(variables["params"], model))
    with torch.no_grad():
        z, g = model(torch.from_numpy(zr), torch.from_numpy(zd))
    jz, jg = jrgb.GatedMoE().apply(variables, zr, zd)
    assert z.shape == g.shape == (24, 1)
    assert max_rel_err(z.numpy(), jz) <= TOL and max_rel_err(g.numpy(), jg) <= TOL


@pytest.mark.parametrize("case", ["two_classes", "one_class"])
def test_train_moe_matches_jax(moe_data, case):
    """``train_moe`` from JAX's initial weights (``PRNGKey(seed)``): the
    fused probs, gates and parameters as JAX's, and the same AUC keys
    (none when ``y`` holds one class: scikit-learn's AUC is undefined)."""
    z_rgb, z_dual, y = moe_data
    epochs = 200
    if case == "one_class":
        y, epochs = np.ones_like(y), 20
    want = jfusion.train_moe(z_rgb, z_dual, y, epochs=epochs, seed=4, log=lambda s: None)
    init = jrgb.GatedMoE().init(jax.random.PRNGKey(4), jnp.asarray(z_rgb)[:, None],
                                jnp.asarray(z_dual)[:, None])
    logged = []
    got = pfusion.train_moe(z_rgb, z_dual, y, epochs=epochs, seed=4, log=logged.append,
                            device="cpu", init=moe_flax_to_torch(tree_np(init["params"])))
    # older scikit-learn raises on one class (JAX then has no AUC key), 1.9
    # gives NaN with a warning: the port leaves the key out either way
    defined = {k for k, v in want.items() if not (isinstance(v, float) and np.isnan(v))}
    assert set(got) == defined
    assert len(logged) == 4 and logged[-1].startswith(f"[moe {epochs}/{epochs}] loss=")
    assert max_rel_err(got["fused_probs"], want["fused_probs"]) <= TOL
    assert max_rel_err(got["gates"], want["gates"]) <= TOL
    got_p = moe_torch_to_flax(got["params"])
    for path, w in jax.tree_util.tree_leaves_with_path(tree_np(want["params"])):
        g = got_p
        for k in path:
            g = g[k.key]
        assert max_rel_err(g, w) <= TOL, path
    for k in ("auc_fused", "auc_rgb", "auc_dual"):
        if k in defined:
            assert abs(got[k] - want[k]) <= 1e-12, k
    assert ("auc_fused" in got) is (case == "two_classes")


def test_align_scores_matches_jax(tmp_path):
    """Keys are basenames without the extension, so a real video and its
    fake of the same name take one dual score (as in JAX); rows without a
    dual score are left out."""
    path = str(tmp_path / "per_video.csv")
    rows = [("v/real/vid_100.y4m", 0.2, 0), ("v/fake/vid_100.y4m", 0.9, 1),
            ("v/real/vid_101.y4m", 0.0, 0), ("v/fake/vid_102.avi", 1.0, 1),
            ("v/fake/vid_103.y4m", 0.5, 1)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_path", "video_score", "gt_label"])
        w.writerows(rows)
    dual = {"vid_100": 0.7, "vid_101": 0.1, "vid_102": 0.999999999}
    got = pfusion.align_scores(path, dual)
    want = jfusion.align_scores(path, dual)
    assert got[3] == want[3] == ["vid_100", "vid_100", "vid_101", "vid_102"]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[1][0] == got[1][1]                              # the shared basename's score


def test_bridges_round_trip_and_refuse(rgb_variables):
    rgb = prgb.DualEncoderRGB(**KW)
    sd = dual_flax_to_torch(rgb_variables["params"], rgb)
    assert_trees_equal(dual_torch_to_flax(sd, KW["heads"]), rgb_variables["params"])
    moe_params = tree_np(jrgb.GatedMoE().init(jax.random.PRNGKey(5), jnp.zeros((2, 1)),
                                              jnp.zeros((2, 1))))["params"]
    moe = prgb.GatedMoE()
    assert_trees_equal(moe_torch_to_flax(moe_flax_to_torch(moe_params, moe)), moe_params)

    missing = {k: v for k, v in rgb_variables["params"].items() if k != "rgb_proj"}
    with pytest.raises(ValueError, match="rgb_proj"):
        dual_flax_to_torch(missing, rgb)
    with pytest.raises(ValueError, match="unexpected flax leaf"):
        moe_flax_to_torch(dict(moe_params, temperature=np.ones(())))
    with pytest.raises(ValueError, match="missing"):
        moe_flax_to_torch({k: v for k, v in moe_params.items() if k != "t_dual"}, moe)
    wide = dict(moe_params, gate_fc1={"kernel": np.zeros((3, 16), np.float32),
                                      "bias": np.zeros(16, np.float32)})
    with pytest.raises(ValueError, match="shape_mismatch"):
        moe_flax_to_torch(wide, moe)
