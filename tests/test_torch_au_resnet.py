"""The port's LibreFace AU ResNet-18 against the JAX package
(``stdd_torch/models/au_resnet.py`` vs ``stdd_tpu/models/au_resnet.py``).

Tolerances (float32 on the CPU):
- activations with bridged flax weights whose BatchNorm statistics are
  randomised: ≤ 1e-5;
- ``preprocess_faces`` (``jax.image.resize`` linear + antialias, centre
  crop, ImageNet normalize) on an upscale (224 → 256), a downscale
  (320 → 256) and a non-square face: ≤ 1e-4 in normalized units (about
  0.006 of a grey level; the port builds the resize weights in float64);
- a torchvision-convention state dict loaded by both packages: the same
  activations ≤ 1e-5;
- the binary AU dicts: equal wherever |activation − 0.5| > 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stdd_tpu.models.au_resnet as J
from stdd_torch.models import au_resnet as T
from stdd_torch.utils.weights import flax_to_torch, torch_to_flax

from test_au_resnet import _torch_oracle


def _random_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_bn(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def variables():
    v = jax.jit(J.AUResNet18().init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.7, 1.3, a.shape)).astype(np.float32)
        if a.ndim == 1 else a, dict(v["params"]))
    return {"params": params, "batch_stats": _random_bn(dict(v["batch_stats"]), rng)}


@pytest.fixture(scope="module")
def extractors(variables):
    return (J.AUExtractor(jax.tree_util.tree_map(jnp.asarray, variables)),
            T.AUExtractor(variables, device="cpu"))


def test_activations_match_jax_with_bridged_weights(extractors):
    jx, tx = extractors
    faces = np.random.RandomState(1).randint(0, 256, (3, 224, 224, 3), np.uint8)
    want = jx.activations(faces)
    got = tx.activations(faces)
    assert got.shape == (3, 12)
    np.testing.assert_allclose(got, want, atol=1e-5)
    feats = tx.model(T.preprocess_faces(torch.from_numpy(faces)), return_features=True)[1]
    assert feats.shape == (3, 512)


@pytest.mark.parametrize("hw", [(224, 224), (320, 320), (200, 260)],
                         ids=["upscale", "downscale", "non_square"])
def test_preprocess_faces_matches_jax_resize(hw):
    faces = np.random.RandomState(hw[0]).randint(0, 256, (2,) + hw + (3,), np.uint8)
    want = np.asarray(J.preprocess_faces(jnp.asarray(faces)))
    got = T.preprocess_faces(torch.from_numpy(faces)).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_torchvision_state_dict_loads_alike_in_both_packages(tmp_path):
    _, oracle = _torch_oracle()
    sd = oracle.state_dict()
    path = str(tmp_path / "au.pt")
    torch.save({"state_dict": sd}, path)
    jx = J.AUExtractor.from_torch_checkpoint(path)
    tx = T.AUExtractor.from_torch_checkpoint(path, device="cpu")
    faces = np.random.RandomState(2).randint(0, 256, (2, 180, 160, 3), np.uint8)
    want = jx.activations(faces)
    np.testing.assert_allclose(tx.activations(faces), want, atol=1e-5)
    # the reference's Sequential-wrapped encoder names load the same weights
    seq = {k.replace("conv1.", "encoder.0.", 1) if k.startswith("conv1.") else
           k.replace("bn1.", "encoder.1.", 1) if k.startswith("bn1.") else
           k.replace("layer1.", "encoder.4.", 1) if k.startswith("layer1.") else k: v
           for k, v in sd.items()}
    model = T.load_torchvision_state_dict(T.AUResNet18(), {"module." + k: v for k, v in seq.items()})
    for k, v in model.state_dict().items():
        assert torch.equal(v, tx.model.state_dict()[k]), k
    with pytest.raises(ValueError, match="stray"):
        T.torchvision_to_port_keys(dict(sd, stray=torch.zeros(1)))


def test_binary_dicts_agree_away_from_the_threshold(extractors):
    jx, tx = extractors
    faces = np.random.RandomState(3).randint(0, 256, (4, 200, 180, 3), np.uint8)
    acts = tx.activations(faces)
    want, got = jx(faces), tx(faces)
    assert len(got) == 4 and set(got[0]) == set(T.AU_KEYS) == set(J.AU_KEYS)
    far = np.abs(acts - 0.5) > 1e-3
    assert far.mean() > 0.9
    for b in range(4):
        for k, key in enumerate(T.AU_KEYS):
            assert got[b][key] in (0.0, 1.0)
            if far[b, k]:
                assert got[b][key] == want[b][key], (b, key, acts[b, k])


def test_bridge_round_trip_and_random_init(variables):
    model = T.AUResNet18()
    sd = flax_to_torch(variables, model, "AU ResNet-18")
    back = torch_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="missing"):
        flax_to_torch({"params": {k: v for k, v in variables["params"].items() if k != "fc2"},
                          "batch_stats": variables["batch_stats"]}, model, "AU ResNet-18")
    a = T.AUExtractor.random_init(seed=4, device="cpu")
    b = T.AUExtractor.random_init(seed=4, device="cpu")
    faces = np.random.RandomState(5).randint(0, 256, (2, 224, 224, 3), np.uint8)
    acts = a.activations(faces)
    np.testing.assert_array_equal(acts, b.activations(faces))
    assert acts.shape == (2, 12) and np.isfinite(acts).all()
