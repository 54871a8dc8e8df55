"""The reference-checkpoint loader (``stdd_torch/utils/torch_convert.py``)
and ``ClipScorer.from_torch_checkpoint`` against the JAX package's
``stdd_tpu/utils/torch_convert.py`` and ``ClipScorer.from_torch_checkpoint``.

The state dicts are synthetic: the port's models with random weights (BN
statistics randomized), written under the reference's keys. Each map must
give JAX's flax tree exactly; the two scorers over the same ``.pth`` must
give the same probs within 1e-4 (float32; the JAX scorer on its exact
gather warp, the port's on K1's plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.utils import torch_convert as jax_convert
from stdd_torch.config import I3DConfig
from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.utils import torch_convert
from stdd_torch.utils.weights import dual_flax_to_torch, dual_torch_to_flax, i3d_flax_to_torch

from torch_port_helpers import port_i3d_variables

CFG = dict(num_frames=8, crop_size=64)
P_TOL = 1e-4


def assert_same_tree(got, want, path=""):
    assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


@pytest.fixture(scope="module")
def i3d_reference():
    """(port variables, reference-keyed state dict) of a small I3D."""
    variables = port_i3d_variables(I3DConfig(**CFG), seed=0)
    return variables, torch_convert.i3d_torch_to_reference(i3d_flax_to_torch(variables))


def test_i3d_reference_keys_are_the_reference_layout(i3d_reference):
    _, ref = i3d_reference
    for key in ("resnet.s1.pathway0_stem.conv.weight", "resnet.s1.pathway0_stem.bn.running_var",
                "resnet.s2.pathway0_res0.branch2.a.weight", "resnet.s2.pathway0_res0.branch2.a_bn.weight",
                "resnet.s2.pathway0_res0.branch1.weight", "resnet.s2.pathway0_res0.branch1_bn.bias",
                "resnet.s5.pathway0_res2.branch2.c_bn.num_batches_tracked",
                "resnet.head.projection.weight"):
        assert key in ref, key
    assert not any(".conv.weight" in k and "stem" not in k for k in ref)


@pytest.mark.parametrize("wrap", ["bare", "module_prefix", "classifier", "state_dict"])
def test_i3d_map_matches_jax(i3d_reference, tmp_path, wrap):
    variables, ref = i3d_reference
    if wrap == "module_prefix":
        ref = {"module." + k: v for k, v in ref.items()}
    obj = {"bare": ref, "module_prefix": ref, "classifier": {"classifier": ref, "epoch": 3},
           "state_dict": {"state_dict": ref}}[wrap]
    path = str(tmp_path / "ref.pth")
    torch.save(obj, path)
    got = torch_convert.load_reference_checkpoint(path)
    assert_same_tree(got, jax_convert.load_reference_checkpoint(path))
    if wrap == "bare":
        assert_same_tree(torch_convert.i3d_reference_to_flax(ref), jax_convert.i3d_torch_to_flax(ref))
    # and the tree is the one the reference keys were written from
    assert_same_tree(got, variables)


def test_i3d_map_refuses_an_unknown_leaf(i3d_reference):
    _, ref = i3d_reference
    bad = dict(ref, **{"resnet.s1.pathway0_stem.bn.momentum_buf": torch.zeros(3)})
    for fn in (torch_convert.i3d_reference_to_flax, jax_convert.i3d_torch_to_flax):
        with pytest.raises(KeyError, match="momentum_buf"):
            fn(bad)


def dual_reference(p: dict, heads: int) -> dict:
    """A flax dual params tree under the reference ``DualEncoderAU_LMK``'s
    state-dict keys (the inverse of JAX's ``dual_torch_to_flax``)."""
    sd = {}
    for branch in ("au_enc", "lmk_enc"):
        b = p[branch]
        sd[f"{branch}.proj.weight"] = b["proj"]["kernel"].T
        sd[f"{branch}.proj.bias"] = b["proj"]["bias"]
        sd[f"{branch}.ln_in.weight"] = b["ln_in"]["scale"]
        sd[f"{branch}.ln_in.bias"] = b["ln_in"]["bias"]
        for i in range(3):
            sd[f"{branch}.temporal.{i}.weight"] = b[f"temporal{i}"]["kernel"].transpose(2, 1, 0)
            sd[f"{branch}.temporal.{i}.bias"] = b[f"temporal{i}"]["bias"]
        sd[f"{branch}.pointwise.weight"] = b["pointwise"]["kernel"].transpose(2, 1, 0)
        sd[f"{branch}.pointwise.bias"] = b["pointwise"]["bias"]
        sd[f"{branch}.pool.v"] = b["pool"]["v"]
        li = 0
        while f"layer{li}" in b:
            lay, pre = b[f"layer{li}"], f"{branch}.encoder.layers.{li}"
            att = lay["self_attn"]
            d = att["query"]["kernel"].shape[0]
            sd[f"{pre}.self_attn.in_proj_weight"] = np.concatenate(
                [att[n]["kernel"].reshape(d, d).T for n in ("query", "key", "value")])
            sd[f"{pre}.self_attn.in_proj_bias"] = np.concatenate(
                [att[n]["bias"].reshape(d) for n in ("query", "key", "value")])
            sd[f"{pre}.self_attn.out_proj.weight"] = att["out"]["kernel"].reshape(d, d).T
            sd[f"{pre}.self_attn.out_proj.bias"] = att["out"]["bias"]
            for n in ("linear1", "linear2"):
                sd[f"{pre}.{n}.weight"] = lay[n]["kernel"].T
                sd[f"{pre}.{n}.bias"] = lay[n]["bias"]
            for n in ("norm1", "norm2"):
                sd[f"{pre}.{n}.weight"] = lay[n]["scale"]
                sd[f"{pre}.{n}.bias"] = lay[n]["bias"]
            li += 1
    for ref, name, kind in (("head.0", "head_ln", "ln"), ("head.1", "head_fc1", "fc"),
                            ("head.4", "head_fc2", "fc"), ("au_from_lmk.0", "au_from_lmk_ln", "ln"),
                            ("au_from_lmk.1", "au_from_lmk_fc", "fc"), ("proj_au", "proj_au", "fc"),
                            ("proj_lmk", "proj_lmk", "fc"), ("domain_head", "domain_head", "fc")):
        sd[f"{ref}.weight"] = p[name]["scale"] if kind == "ln" else p[name]["kernel"].T
        sd[f"{ref}.bias"] = p[name]["bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_dual_map_matches_jax():
    heads = 4
    model = DualEncoderAU_LMK(au_dim=12, lmk_dim=20, d_model=16, depth=2, heads=heads,
                              use_dat=True, domain_classes=3, aux_heads=True, seed=0)
    p = dual_torch_to_flax(model.state_dict(), heads=heads)
    sd = dual_reference(p, heads)
    got = torch_convert.dual_reference_to_flax(sd, heads=heads)
    assert_same_tree(got, jax_convert.dual_torch_to_flax(sd, heads=heads))
    assert_same_tree(got["params"], p)
    # the tree covers the port's model
    dual_flax_to_torch(got["params"], model=model)


def _batch(rng, B=3, T=8, S=96, n_valid=2):
    crops = np.zeros((B, T, S, S, 3), np.uint8)
    crops[:n_valid] = rng.randint(0, 256, (n_valid, T, S, S, 3), np.uint8)
    boxes = np.zeros((B, T, 4), np.float32)
    lm5 = np.zeros((B, T, 5, 2), np.float32)
    for b in range(n_valid):
        xy = 200.0 + np.cumsum(rng.uniform(-2, 2, (T, 2)), 0)
        boxes[b, :, :2], boxes[b, :, 2:] = xy, xy + S
        lm5[b] = STD_POINTS_256 * (80 / 256.0) + 8.0 + rng.normal(0, 0.5, (T, 5, 2))
    return crops, boxes, lm5, np.arange(B) < n_valid


def test_from_torch_checkpoint_matches_jax(i3d_reference, tmp_path):
    variables, ref = i3d_reference
    path = str(tmp_path / "ref.pth")
    torch.save({"classifier": ref}, path)
    ts = ClipScorer.from_torch_checkpoint(path, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                          device="cpu")
    js = JaxClipScorer.from_torch_checkpoint(path, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                                             use_pallas_warp=False)
    batch = _batch(np.random.RandomState(0))
    got, want = ts.score(*batch), np.asarray(js.score(*batch))
    assert np.all((got[:2] > 0) & (got[:2] < 1)) and np.all(got[2:] == 0)
    assert np.abs(got - want).max() <= P_TOL
    # the same weights as the scorer the file was written from
    src = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                         device="cpu")
    np.testing.assert_array_equal(got, src.score(*batch))


def test_from_torch_checkpoint_refuses_a_partial_file(i3d_reference, tmp_path):
    _, ref = i3d_reference
    path = str(tmp_path / "partial.pth")
    torch.save({k: v for k, v in ref.items() if "s5." not in k}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        ClipScorer.from_torch_checkpoint(path, cfg=I3DConfig(**CFG), device="cpu")
