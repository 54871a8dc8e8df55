"""The port's I3D-R50 eval forward and weight bridge against the JAX model.

Geometry: ``I3DConfig(num_frames=8, crop_size=64)``, the CPU geometry of
``bench.py``. Weights: the JAX initializers with random BN statistics
(``torch_port_helpers``), bridged into the torch model. Tolerance: in
float32, max |Δ| ≤ 1e-4 · max(1, max |reference|) for the logits and the
2048-wide pooled features (the two frameworks sum the convolutions in
another order; 1e-4 leaves two orders of magnitude over the observed
difference).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.models.i3d import I3D as JaxI3D
from stdd_torch.config import I3DConfig
from stdd_torch.models.i3d import I3D
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.utils.weights import i3d_flax_to_torch

from torch_port_helpers import jax_i3d_variables, max_rel_err

CFG = dict(num_frames=8, crop_size=64)
TOL = 1e-4


@pytest.fixture(scope="module")
def variables():
    return jax_i3d_variables(JaxI3DConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def clips():
    return np.random.RandomState(3).randn(2, CFG["num_frames"], CFG["crop_size"],
                                          CFG["crop_size"], 3).astype(np.float32)


@pytest.fixture(scope="module")
def torch_out(variables, clips):
    model = I3D(I3DConfig(**CFG))
    model.load_state_dict(i3d_flax_to_torch(variables, model))
    with torch.inference_mode():
        logits, feats = model.eval()(torch.from_numpy(clips), return_features=True)
    return model, logits.numpy(), feats.numpy()


def _jax_forward(variables, clips, **flags):
    model = JaxI3D(cfg=JaxI3DConfig(**CFG, **flags))
    fn = jax.jit(lambda v, x: model.apply(v, x, train=False, return_features=True))
    logits, feats = fn(variables, jnp.asarray(clips))
    return np.asarray(logits), np.asarray(feats)


def test_i3d_logits_and_features_match_jax(variables, clips, torch_out):
    _, lt, ft = torch_out
    lj, fj = _jax_forward(variables, clips)
    assert lt.shape == lj.shape == (2, 1) and ft.shape == fj.shape == (2, 2048)
    assert np.isfinite(lt).all() and np.isfinite(ft).all()
    # a live network: the features vary across clips and channels
    assert ft.std() > 1e-3 and abs(lt[0, 0] - lt[1, 0]) > 1e-4
    assert max_rel_err(lt, lj) <= TOL, (lt, lj)
    assert max_rel_err(ft, fj) <= TOL


@pytest.mark.parametrize("flags", [dict(s2d_stem=True), dict(s2d_stem=True, stem_t2=True)],
                         ids=["s2d_stem", "stem_t2"])
def test_i3d_matches_jax_stem_relayouts(variables, clips, torch_out, flags):
    """The JAX model's TPU re-layouts of the stem (space-to-depth, and the
    temporal-pair packing on top of it) are exact: the same torch model,
    which computes the plain convolution, matches them too."""
    _, lt, ft = torch_out
    lj, fj = _jax_forward(variables, clips, **flags)
    assert max_rel_err(lt, lj) <= TOL
    assert max_rel_err(ft, fj) <= TOL


def test_i3d_bf16_drift_is_bounded(variables, clips, torch_out):
    """bf16 compute over float32 parameters (the scorer's default) stays
    within 2% of the float32 logits and features: bf16 keeps 8 mantissa
    bits (0.4% per rounding) and the error grows over ~50 layers."""
    model32, lt, ft = torch_out
    model16 = I3D(I3DConfig(**CFG), dtype=torch.bfloat16)
    model16.load_state_dict(model32.state_dict())
    with torch.inference_mode():
        lb, fb = model16.eval()(torch.from_numpy(clips), return_features=True)
    assert lb.dtype == fb.dtype == torch.float32
    assert max_rel_err(lb.numpy(), lt) <= 0.02
    assert max_rel_err(fb.numpy(), ft) <= 0.02


def test_weight_bridge_consumes_every_leaf(variables):
    model = I3D(I3DConfig(**CFG))
    sd = i3d_flax_to_torch(variables, model)
    assert set(sd) == set(model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    # every flax leaf lands in one entry; BN adds num_batches_tracked
    n_bn = sum(1 for k in sd if k.endswith("num_batches_tracked"))
    assert len(sd) == n_leaves + n_bn
    model.load_state_dict(sd, strict=True)
    k = "s1.pathway0_stem.conv.kernel"
    w = variables["params"]["s1"]["pathway0_stem"]["conv"]["kernel"]   # [t,h,w,Cin,Cout]
    np.testing.assert_array_equal(sd[k.replace("kernel", "weight")].numpy(),
                                  np.transpose(w, (4, 3, 0, 1, 2)))
    hw = variables["params"]["head"]["projection"]["kernel"]            # [C, K]
    np.testing.assert_array_equal(sd["head.projection.weight"].numpy(), hw.T)


def _broken(variables, how):
    v = {c: jax.tree_util.tree_map(lambda a: a, dict(t)) for c, t in variables.items()}
    v["params"] = dict(v["params"])
    if how == "missing":
        head = dict(v["params"]["head"])
        head["projection"] = {"kernel": head["projection"]["kernel"]}   # bias dropped
        v["params"]["head"] = head
    elif how == "extra_leaf":
        v["params"]["extra"] = {"conv": {"bias": np.zeros(3, np.float32)}}
    elif how == "extra_collection":
        v["opt_state"] = {"mu": np.zeros(3, np.float32)}
    elif how == "shape":
        head = dict(v["params"]["head"])
        head["projection"] = {"kernel": np.zeros((2048, 2), np.float32),
                              "bias": np.zeros(2, np.float32)}
        v["params"]["head"] = head
    return v


@pytest.mark.parametrize("how", ["missing", "extra_leaf", "extra_collection", "shape"])
def test_weight_bridge_raises_on_mismatch(variables, how):
    bad = _broken(variables, how)
    with pytest.raises(ValueError):
        i3d_flax_to_torch(bad, I3D(I3DConfig(**CFG)))
    with pytest.raises((ValueError, RuntimeError)):
        ClipScorer.from_flax_variables(bad, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                       device="cpu")


def test_random_init_follows_jax_initializers(variables):
    """``ClipScorer.random_init`` draws the JAX model's initializers: MSRA
    fan-out conv fill, BN ones/zeros with zero-init final BN scales, normal
    head with std ``fc_init_std``, zero head bias."""
    cfg = I3DConfig(**CFG)
    sd = ClipScorer.random_init(cfg, seed=1, dtype=torch.float32, device="cpu").model.state_dict()
    jax_init = jax.tree_util.tree_map(np.asarray, JaxI3D(cfg=JaxI3DConfig(**CFG)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 64, 64, 3)), train=False))
    ref = i3d_flax_to_torch(jax_init)
    assert set(sd) == set(ref)
    for k, t in sd.items():
        r = ref[k].numpy()
        assert t.shape == r.shape, k
        if k.endswith(("bn.weight", "bn.bias", "running_mean", "running_var", "projection.bias")):
            np.testing.assert_array_equal(t.numpy(), r, err_msg=k)
        elif t.numel() >= 4096:
            # same distribution: the standard deviations agree within 10%
            assert abs(float(t.std()) / float(r.std()) - 1.0) < 0.1, k


def test_unported_options_are_refused():
    for flags in (dict(int8_stages=("s3",)), dict(fused_s2=True, int8_stages=("s4", "s5"))):
        with pytest.raises(NotImplementedError, match="item 9"):
            I3D(dataclasses.replace(I3DConfig(**CFG), **flags))


def test_i3d_fused_s2_matches_jax_fused_s2(variables, clips, torch_out):
    """``fused_s2``: each stride-1 block of s2 is one K2 call over
    BN-folded weights (its plain version on the CPU), against the JAX
    model's fused blocks (the Pallas kernel in interpret mode) on the same
    bridged variables. The fused model loads the unfused model's
    ``state_dict`` as it is, and stays within TOL of it too."""
    model32, lt, ft = torch_out
    fused = I3D(I3DConfig(**CFG, fused_s2=True))
    assert set(fused.state_dict()) == set(model32.state_dict())
    fused.load_state_dict(i3d_flax_to_torch(variables, fused))
    assert [m.fused_eval for m in fused.s2.children()] == [True] * 3
    assert not any(m.fused_eval for st in (fused.s3, fused.s4, fused.s5) for m in st.children())
    with torch.inference_mode():
        lf, ff = fused.eval()(torch.from_numpy(clips), return_features=True)
    lj, fj = _jax_forward(variables, clips, fused_s2=True)
    assert max_rel_err(lf.numpy(), lj) <= TOL
    assert max_rel_err(ff.numpy(), fj) <= TOL
    assert max_rel_err(lf.numpy(), lt) <= TOL and max_rel_err(ff.numpy(), ft) <= TOL


def test_i3d_fused_s2_bf16_drift_is_bounded(torch_out, clips):
    """bf16 through the fused s2 (weights folded in float32, then rounded
    once) stays within the bound the unfused bf16 model meets."""
    model32, lt, ft = torch_out
    fused16 = I3D(I3DConfig(**CFG, fused_s2=True), dtype=torch.bfloat16)
    fused16.load_state_dict(model32.state_dict())
    with torch.inference_mode():
        lb, fb = fused16.eval()(torch.from_numpy(clips), return_features=True)
    assert max_rel_err(lb.numpy(), lt) <= 0.02
    assert max_rel_err(fb.numpy(), ft) <= 0.02
