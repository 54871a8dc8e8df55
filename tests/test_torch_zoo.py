"""The rest of the port's model zoo against the JAX package on the CPU: the
registry, SlowFast and the Non-local block, the seven ResUNet variants with
their freeze masks, VideoiT and the space-time transformer, the 2D ResNet,
RetinaFace with its decode and detector, the GDConv landmarker with its
feed and reprojection, SCRFD on a random graph of its layout, and the
reference-checkpoint converters.

Weights: the port's initializers with every norm's scale and shift and
every BN statistic randomized by a numpy seed, carried to a flax tree by
``utils/weights.py::torch_to_flax``; the JAX modules apply that tree
(jitted once each). Widths are the narrowest that keep each structure (the
3D nets at ResNet-18 depths, 8 channels a group); float32, ≤ 1e-4 ·
max(1, max |JAX|) unless a test states otherwise.

The converters: a random state dict under the reference's key names (the
port model's weights renamed to the reference layout) goes through the JAX
converter and through the port's; the two flax trees must be equal, and
the port's tree must load back into the port model as the weights it came
from.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stdd_tpu.models as jax_models
from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.models import landmark_net as jax_lmk
from stdd_tpu.models import retinaface as jax_rf
from stdd_tpu.models.resnet2d import ResNet2D as JaxResNet2D
from stdd_tpu.models.scrfd import SCRFDDetector as JaxSCRFD
from stdd_tpu.models.slowfast import Nonlocal as JaxNonlocal
from stdd_tpu.models.slowfast import SlowFast as JaxSlowFast
from stdd_tpu.models.unet3d import RESUNET_VARIANTS, freeze_mask_by_prefix as jax_freeze
from stdd_tpu.models.unet3d import make_resunet as jax_make_resunet
from stdd_tpu.models.vit import SpatialTemporalTransformer as JaxST
from stdd_tpu.models.vit import VideoiT as JaxVideoiT
from stdd_tpu.utils import torch_convert as jax_conv
import stdd_torch.models as port_models
from stdd_torch.config import I3DConfig
from stdd_torch.models import landmark_net, retinaface, unet3d
from stdd_torch.models.ftcn import FTCN
from stdd_torch.models.resnet2d import ResNet2D
from stdd_torch.models.scrfd import SCRFDDetector
from stdd_torch.models.slowfast import Nonlocal, SlowFast
from stdd_torch.models.vit import SpatialTemporalTransformer, VideoiT
from stdd_torch.utils import torch_convert as conv
from stdd_torch.utils.onnx_writer import scrfd_shaped_graph, write_onnx
from stdd_torch.utils.weights import flax_to_torch, torch_to_flax

from torch_port_helpers import flax_without_dropout, max_rel_err

TOL = 1e-4
NARROW = dict(depth=18, width_per_group=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize_norms(tree, rng):
    """Random scales and shifts of every norm (a ``scale`` leaf and its
    ``bias``) and random BN statistics, in place of the initializers' ones
    and zeros."""
    def walk(node, stats):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, stats)
            elif stats and k == "mean":
                node[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif stats and k == "var":
                node[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
            elif k == "scale":
                node[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
                if "bias" in node:
                    node["bias"] = rng.normal(0.0, 0.1, node["bias"].shape).astype(np.float32)
    walk(tree["params"], False)
    if "batch_stats" in tree:
        walk(tree["batch_stats"], True)
    return tree


def port_tree(model, seed: int, to_flax=torch_to_flax) -> dict:
    """``model`` with the port's initializers drawn from ``seed`` and random
    norms, loaded back into it; returns the flax tree."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    v = randomize_norms(to_flax(model.state_dict()), np.random.RandomState(seed + 1))
    model.load_state_dict(flax_to_torch(v, model))
    return v


def assert_shapes_match(jax_module, v, *args, **kw):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *args, **kw))
    for coll in shapes:
        assert jax.tree_util.tree_map(lambda a: a.shape, shapes[coll]) == \
            jax.tree_util.tree_map(np.shape, v[coll]), coll


def clip(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the registry ------------------------------------------------------------------

def test_registry_has_jax_names_and_its_key_error():
    assert sorted(port_models.MODEL_REGISTRY) == sorted(jax_models.MODEL_REGISTRY)
    with pytest.raises(KeyError) as pe:
        port_models.build_model("nope")
    with pytest.raises(KeyError) as je:
        jax_models.build_model("nope")
    assert str(pe.value) == str(je.value)
    tiny = I3DConfig(**NARROW, num_frames=8, crop_size=32)
    assert isinstance(port_models.build_model("ftcn_tt", tiny), FTCN)
    assert port_models.build_model("ftcn_tt", tiny).cfg.temporal_only
    assert dataclasses.astuple(port_models.build_model("resunet_strong", tiny).variant) == \
        dataclasses.astuple(RESUNET_VARIANTS["strong"])
    assert port_models.build_model("resunet_light", tiny).variant.decoder == "light"


# -- SlowFast and Non-local ----------------------------------------------------------

def test_slowfast_matches_jax():
    """Eval logits of both pathways with their three lateral fusions (the
    train-mode BN is the I3D's ``Conv3dBN``, held by the I3D and FTCN train
    tests)."""
    cfg = dict(NARROW, num_frames=8, crop_size=32)
    model = SlowFast(I3DConfig(**cfg))
    v = port_tree(model, 0)
    x = clip((2, 8, 32, 32, 3))
    jm = JaxSlowFast(cfg=JaxI3DConfig(**cfg))
    assert_shapes_match(jm, v, x)
    with torch.no_grad():
        assert max_rel_err(model(torch.from_numpy(x)).numpy(), jax.jit(jm.apply)(v, x)) <= TOL


@pytest.mark.parametrize("instantiation,pool", [("softmax", (1, 2, 2)), ("dot_product", None)])
def test_nonlocal_matches_jax(instantiation, pool):
    m = Nonlocal(16, 8, instantiation, pool)
    v = port_tree(m, 3)
    x = clip((2, 4, 6, 6, 16), 4)
    jm = JaxNonlocal(8, instantiation, pool)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert max_rel_err(got.numpy(), jax.jit(jm.apply)(v, x)) <= TOL


# -- the ResUNet family --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RESUNET_VARIANTS))
def test_resunet_variant_matches_jax(name):
    """Masks [B, T, H/4, W/4, n_labels] and the verdict of each variant; its
    freeze masks against JAX's over the same tree."""
    cfg = dict(NARROW, num_frames=4, crop_size=32)
    model = unet3d.make_resunet(name, I3DConfig(**cfg))
    v = port_tree(model, 5)
    x = clip((2, 4, 32, 32, 3), 6)
    jm = jax_make_resunet(name, JaxI3DConfig(**cfg))
    jmask, jout = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        mask, out = model(torch.from_numpy(x))
    assert mask.shape == jmask.shape and out.shape == jout.shape
    assert max_rel_err(mask.numpy(), jmask) <= TOL and max_rel_err(out.numpy(), jout) <= TOL
    params = dict(model.named_parameters())
    for prefixes in (["s1", "s2", "s3", "s4"], ["linear"]):
        mask_t = unet3d.freeze_mask_by_prefix(params, prefixes)
        mapped = torch_to_flax({k: torch.full((1,) * p.ndim, float(mask_t[k]))
                                for k, p in params.items()})["params"]
        want = jax_freeze(v["params"], prefixes)
        assert jax.tree_util.tree_map(lambda a: bool(a.reshape(-1)[0]), mapped) == want
    assert all(unet3d.unfreeze_mask(params).values())


def test_resunet_freeze_backbone_and_labels():
    """``freeze_backbone`` stops every encoder gradient and keeps the
    decoders'; ``labels`` overrides the variant's list."""
    cfg = I3DConfig(**NARROW, num_frames=4, crop_size=32)
    model = unet3d.ResUNet3D(cfg, labels=("a",))
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(clip((1, 4, 32, 32, 3)))
    masks, out = model(x, freeze_backbone=True)
    (masks.sum() + out.sum()).backward()
    enc = [p.grad for k, p in model.named_parameters() if k.split(".")[0] in ("s1", "s2", "s3", "s4")]
    assert all(g is None for g in enc)
    assert model.t4_a.conv1.Conv_0.weight.grad.abs().sum() > 0 and masks.shape[-1] == 1


# -- the video transformers ------------------------------------------------------------

def test_videoit_matches_jax(monkeypatch):
    """Eval over every interior patch (a 7×7 grid: the reference's test
    drops the left, right and bottom border, 30 patches stay), then train
    mode with RandomSelect's patches injected and dropout off."""
    kw = dict(image_size=56, patch_size=8, num_frames=4, dim=32, depth=2, heads=2, dim_head=8,
              mlp_dim=64, random_select=True, k=3, dropout=0.1)
    model = VideoiT(**kw)
    v = port_tree(model, 7)
    x = jnp.asarray(clip((2, 4, 56, 56, 3), 8))
    jm = JaxVideoiT(**kw)
    assert_shapes_match(jm, v, x)
    with torch.no_grad():
        got = model(torch.from_numpy(np.asarray(x)))
    want = jax.jit(jm.apply)(v, x)
    assert got.shape == want.shape == (2, 30) and max_rel_err(got.numpy(), want) <= TOL
    sites = [8, 30, 16]
    monkeypatch.setattr(jax.random, "choice", lambda *a, **k: jnp.asarray(sites))
    model.transformer.dropout = 0.0
    with flax_without_dropout():
        want = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                             rngs={"patch": jax.random.PRNGKey(0)}))(v, x)
    with torch.no_grad():
        got = model(torch.from_numpy(np.asarray(x)), train=True, sites=sites)
    assert got.shape == (2, 3) and max_rel_err(got.numpy(), want) <= TOL


def test_st_transformer_matches_jax():
    kw = dict(image_size=32, patch_size=8, num_frames=4, dim=32, depth=2, heads=2, dim_head=8,
              scale_dim=2)
    model = SpatialTemporalTransformer(**kw)
    v = port_tree(model, 9)
    x = clip((2, 4, 32, 32, 3), 10)
    jm = JaxST(**kw)
    assert_shapes_match(jm, v, x)
    with torch.no_grad():
        assert max_rel_err(model(torch.from_numpy(x)).numpy(), jax.jit(jm.apply)(v, x)) <= TOL


# -- the 2D ResNet ----------------------------------------------------------------

@pytest.mark.parametrize("variant", ["resnet18", "resnext50_32x4d"])
def test_resnet2d_matches_jax_and_freezes(variant):
    """Logits of a basic-block and a grouped-bottleneck variant; with
    ``freeze_backbone`` only the fc gets a gradient (the JAX test's check)."""
    model = ResNet2D(variant)
    v = port_tree(model, 11)
    x = clip((2, 32, 32, 3), 12)
    jm = JaxResNet2D(variant)
    if variant == "resnet18":
        assert_shapes_match(jm, v, x)
    with torch.no_grad():
        assert max_rel_err(model(torch.from_numpy(x)).numpy(), jax.jit(jm.apply)(v, x)) <= TOL
    out = model(torch.from_numpy(x), freeze_backbone=True)
    (out ** 2).sum().backward()
    assert model.conv1.weight.grad is None and model.fc.weight.grad.abs().sum() > 0


# -- RetinaFace ------------------------------------------------------------------

def test_retinaface_heads_decode_and_detector_match_jax():
    """The heads on one frame, the priors, both decodes, and the detector's
    rows (host NMS against JAX's device NMS) on the same weights."""
    hw = (96, 128)
    model = retinaface.RetinaFace()
    v = port_tree(model, 13)
    frame = np.random.RandomState(14).randint(0, 255, hw + (3,), np.uint8)
    x = frame[None].astype(np.float32) - jax_rf.BGR_MEAN
    jm = jax_rf.RetinaFace()
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert max_rel_err(g.numpy(), w) <= TOL
    priors = retinaface.prior_boxes(hw)
    np.testing.assert_array_equal(priors, jax_rf.prior_boxes(hw))
    loc, ldm = np.asarray(want[0][0]), np.asarray(want[2][0])
    tp = torch.from_numpy(priors)
    assert max_rel_err(retinaface.decode_boxes(torch.from_numpy(loc), tp).numpy(),
                       jax_rf.decode_boxes(loc, priors)) <= 1e-6
    assert max_rel_err(retinaface.decode_landmarks(torch.from_numpy(ldm), tp).numpy(),
                       jax_rf.decode_landmarks(ldm, priors)) <= 1e-6
    det = retinaface.RetinaFaceDetector(flax_to_torch(v), hw, conf_threshold=0.3, top_k=40,
                                        device="cpu")
    jdet = jax_rf.RetinaFaceDetector(jax.tree_util.tree_map(jnp.asarray, v), hw,
                                     conf_threshold=0.3, top_k=40)
    dets, mask = det.detect(frame)
    jd, jmask = (np.asarray(a) for a in jdet.detect(frame))
    assert mask.sum() > 0 and (mask == jmask).all()
    assert np.abs(dets - jd).max() <= 1e-3


# -- the GDConv landmarker --------------------------------------------------------

def test_landmarker_feed_forward_and_reprojection_match_jax():
    """``prepare_feed`` bit-equal to JAX's cv2 feed (boxes inside and across
    the frame's borders), the net's 136 outputs, and the predictor's
    reprojected points."""
    rng = np.random.RandomState(15)
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    boxes = [(40, 30, 100, 95), (-10, -5, 50, 70), (120, 60, 170, 130)]
    for b in boxes:
        feed, cb = landmark_net.prepare_feed(img, b)
        jfeed, jcb = jax_lmk.prepare_feed(img, b)
        assert cb == jcb and np.array_equal(feed, jfeed)
    pred = landmark_net.LandmarkPredictor(seed=16, device="cpu")
    v = randomize_norms(torch_to_flax(pred.model.state_dict()), np.random.RandomState(17))
    pred = landmark_net.LandmarkPredictor(v, device="cpu")
    jpred = jax_lmk.LandmarkPredictor(jax.tree_util.tree_map(jnp.asarray, v))
    got, want = pred.predict(img, boxes), jpred.predict(img, boxes)
    for g, w, b in zip(got, want, boxes):
        scale = max(1.0, b[2] - b[0])          # points are crop fractions × the crop's side
        assert g.shape == (68, 2) and np.abs(g - w).max() <= TOL * scale


# -- SCRFD ----------------------------------------------------------------------

def test_scrfd_on_a_random_graph_matches_jax(tmp_path):
    """The detector on a graph of scrfd_2.5g_bnkps's layout and output
    names (random weights) in both packages: the same rows."""
    path = write_onnx(scrfd_shaped_graph(0), str(tmp_path / "scrfd.onnx"))
    frame = np.random.RandomState(18).randint(0, 255, (128, 160, 3), np.uint8)
    det = SCRFDDetector(path, top_k=32, device="cpu")
    dets, mask = det.detect(frame)
    jd, jmask = (np.asarray(a) for a in JaxSCRFD(path, top_k=32).detect(frame))
    assert mask.sum() > 0 and (mask == jmask).all()
    assert np.abs(dets - jd).max() <= 1e-3
    assert det.detect_np(frame).shape == (int(mask.sum()), 15)
    with pytest.raises(FileNotFoundError, match="nowhere.onnx"):
        SCRFDDetector(str(tmp_path / "nowhere.onnx"), device="cpu")


# -- the reference-checkpoint converters -------------------------------------------

def _sub(sd, rules):
    """Rename ``sd``'s keys by each (pattern, replacement) in turn."""
    out = {}
    for k, t in sd.items():
        for pat, rep in rules:
            k = re.sub(pat, rep, k)
        out[k] = t
    return out


_I3D_REF = [(r"\.shortcut\.conv\.", ".branch1."), (r"\.shortcut\.bn\.", ".branch1_bn."),
            (r"\.([abc])\.conv\.", r".\1."), (r"\.([abc])\.bn\.", r".\1_bn.")]


def ref_resnet2d(sd):
    return _sub(sd, [(r"^layer(\d)_(\d+)\.conv(\d)\.Conv_0\.", r"layer\1.\2.conv\3."),
                     (r"^layer(\d)_(\d+)\.conv(\d)\.BatchNorm_0\.", r"layer\1.\2.bn\3."),
                     (r"^layer(\d)_(\d+)\.downsample\.Conv_0\.", r"layer\1.\2.downsample.0."),
                     (r"^layer(\d)_(\d+)\.downsample\.BatchNorm_0\.", r"layer\1.\2.downsample.1.")])


def ref_retinaface(sd):
    ssh = {"conv3x3": "conv3X3", "conv5x5_1": "conv5X5_1", "conv5x5_2": "conv5X5_2",
           "conv7x7_2": "conv7X7_2", "conv7x7_3": "conv7x7_3"}
    rules = [(r"^body\.s1_conv\.conv\.", "body.stage1.0.0."), (r"^body\.s1_conv\.bn\.", "body.stage1.0.1.")]
    for prefix, stage, off in (("s1_dw", "stage1", 1), ("s2_dw", "stage2", 0), ("s3_dw", "stage3", 0)):
        for n in range(6):
            for part, idx in (("dw.conv", 0), ("dw.bn", 1), ("pw.conv", 3), ("pw.bn", 4)):
                rules.append((rf"^body\.{prefix}{n}\.{re.escape(part)}\.",
                              f"body.{stage}.{n + off}.{idx}."))
    rules += [(rf"^fpn\.(output\d|merge\d)\.conv\.", r"fpn.\1.0."),
              (rf"^fpn\.(output\d|merge\d)\.bn\.", r"fpn.\1.1.")]
    for ours, theirs in ssh.items():
        rules += [(rf"^ssh(\d)\.{ours}\.conv\.", rf"ssh\1.{theirs}.0."),
                  (rf"^ssh(\d)\.{ours}\.bn\.", rf"ssh\1.{theirs}.1.")]
    rules += [(r"^class_head(\d)\.", r"ClassHead.\1.conv1x1."),
              (r"^bbox_head(\d)\.", r"BboxHead.\1.conv1x1."),
              (r"^ldm_head(\d)\.", r"LandmarkHead.\1.conv1x1.")]
    return _sub(sd, rules)


def ref_resunet(sd):
    return _sub(sd, [(r"^(t[34]_\w+)\.(conv\d)\.Conv_0\.", r"\1.\2.0."),
                     (r"^(t[34]_\w+)\.(conv\d)\.BatchNorm_0\.", r"\1.\2.1."),
                     (r"^(conv1x1_\w+)\.conv1\.", r"\1.0."), (r"^(conv1x1_\w+)\.bn\.", r"\1.1."),
                     (r"^(conv1x1_\w+)\.conv2\.", r"\1.3."), (r"^linear\.", "linear.0.")]
                + _I3D_REF)


def ref_slowfast(sd):
    return _sub(sd, [(r"^(s\d)_slow\.pathway0_", r"\1.pathway0_"),
                     (r"^(s\d)_fast\.pathway0_", r"\1.pathway1_"),
                     (r"^(s\d_fuse)\.conv_f2s\.conv\.", r"\1.conv_f2s."),
                     (r"^(s\d_fuse)\.conv_f2s\.bn\.", r"\1.bn."),
                     (r"^projection\.", "head.projection.")] + _I3D_REF)


def _ref_layers(prefix):
    return [(rf"^{prefix}attn_norm(\d+)\.", r"{T}layers.\1.0.fn.norm."),
            (rf"^{prefix}qkv(\d+)\.", r"{T}layers.\1.0.fn.fn.to_qkv."),
            (rf"^{prefix}attn_out(\d+)\.", r"{T}layers.\1.0.fn.fn.to_out.0."),
            (rf"^{prefix}mlp_norm(\d+)\.", r"{T}layers.\1.1.fn.norm."),
            (rf"^{prefix}mlp_fc1_(\d+)\.", r"{T}layers.\1.1.fn.fn.net.0."),
            (rf"^{prefix}mlp_fc2_(\d+)\.", r"{T}layers.\1.1.fn.fn.net.3.")]


def ref_ftcn(sd):
    head = [(p, r.replace("{T}", "head.time_T.transformer.")) for p, r in _ref_layers(r"head\.")]
    head += [(r"^head\.(cls_token|pos_embedding)$", r"head.time_T.\1"),
             (r"^head\.head_norm\.", "head.time_T.mlp_head.0."),
             (r"^head\.head_fc\.", "head.time_T.mlp_head.1."),
             (r"^s1\.Conv3dBN_0\.conv\.", "s1.pathway0_stem.conv."),
             (r"^s1\.Conv3dBN_0\.bn\.", "s1.pathway0_stem.bn.0."),
             (r"^(s\d)/(pathway0_res\d+)\.shortcut\.Conv3dBN_0\.conv\.", r"\1.\2.branch1."),
             (r"^(s\d)/(pathway0_res0)\.shortcut\.Conv3dBN_0\.bn\.", r"\1.\2.branch1_bn.0."),
             (r"^(s\d)/(pathway0_res\d+)\.([abc])\.Conv3dBN_0\.conv\.", r"\1.\2.branch2.\3."),
             (r"^(s\d)/(pathway0_res0)\.b\.Conv3dBN_0\.bn\.", r"\1.\2.branch2.b_bn.0."),
             (r"^(s\d)/(pathway0_res\d+)\.([abc])\.Conv3dBN_0\.bn\.", r"\1.\2.branch2.\3_bn.")]
    return _sub(sd, head)


def ref_videoit(sd):
    return _sub(sd, [(p, r.replace("{T}", "transformer.")) for p, r in _ref_layers(r"transformer\.")]
                + [(r"^mlp_head\.", "mlp_head.1."), (r"^head_norm\.", "mlp_head.0.")])


def ref_st(sd):
    rules = []
    for t in ("space_transformer", "temporal_transformer"):
        rules += [(p, r.replace("{T}", f"{t}.")) for p, r in _ref_layers(rf"{t}\.")]
    out = _sub(sd, rules + [(r"^mlp_head\.", "mlp_head.1."), (r"^head_norm\.", "mlp_head.0.")])
    del out["patch_to_embedding.weight"], out["patch_to_embedding.bias"]
    return out


def ref_gdconv(sd):
    f = "base_net.0.features"
    rules = [(r"^base\.stem\.conv\.", f"{f}.0.0."), (r"^base\.stem\.bn\.", f"{f}.0.1."),
             (r"^base\.head_conv\.conv\.", f"{f}.18.0."), (r"^base\.head_conv\.bn\.", f"{f}.18.1."),
             (r"^gdconv\.", "linear7.conv."), (r"^gdconv_bn\.", "linear7.bn."),
             (r"^out_conv\.", "linear1.conv."), (r"^out_bn\.", "linear1.bn."),
             (r"^base\.block0\.depthwise\.conv\.", f"{f}.1.conv.0.0."),
             (r"^base\.block0\.depthwise\.bn\.", f"{f}.1.conv.0.1."),
             (r"^base\.block0\.project\.conv\.", f"{f}.1.conv.1."),
             (r"^base\.block0\.project\.bn\.", f"{f}.1.conv.2.")]
    out = {}
    for k, t in _sub(sd, rules).items():
        m = re.match(r"^base\.block(\d+)\.(expand|depthwise|project)\.(conv|bn)\.(.+)$", k)
        if m:   # blocks 1-16 are features.2-17: expand 0, depthwise 1, project 2 and 3
            idx = {("expand", "conv"): "0.0", ("expand", "bn"): "0.1",
                   ("depthwise", "conv"): "1.0", ("depthwise", "bn"): "1.1",
                   ("project", "conv"): "2", ("project", "bn"): "3"}[m.group(2), m.group(3)]
            k = f"{f}.{int(m.group(1)) + 1}.conv.{idx}.{m.group(4)}"
        out[k] = t
    return out


def _models():
    tiny3d = I3DConfig(**NARROW, num_frames=4, crop_size=32)
    return {
        "resnet2d": (lambda: ResNet2D("resnet18"), ref_resnet2d, conv.resnet2d_reference_to_flax,
                     jax_conv.resnet2d_torch_to_flax),
        "retinaface": (retinaface.RetinaFace, ref_retinaface, conv.retinaface_reference_to_flax,
                       jax_conv.retinaface_torch_to_flax),
        "resunet": (lambda: unet3d.make_resunet("strong", tiny3d), ref_resunet,
                    conv.resunet_reference_to_flax, jax_conv.resunet_torch_to_flax),
        "slowfast": (lambda: SlowFast(tiny3d), ref_slowfast, conv.slowfast_reference_to_flax,
                     jax_conv.slowfast_torch_to_flax),
        "ftcn": (lambda: FTCN(I3DConfig(**NARROW, num_frames=8, crop_size=64, temporal_only=True)),
                 ref_ftcn, conv.ftcn_reference_to_flax, jax_conv.ftcn_torch_to_flax),
        "videoit": (lambda: VideoiT(32, 8, 4, dim=32, depth=2, heads=2, dim_head=8, mlp_dim=64),
                    ref_videoit, conv.videoit_reference_to_flax, jax_conv.videoit_torch_to_flax),
        "st_transformer": (lambda: SpatialTemporalTransformer(16, 4, 4, dim=48, depth=1, heads=2,
                                                              dim_head=8, scale_dim=2),
                           ref_st, conv.st_transformer_reference_to_flax,
                           jax_conv.st_transformer_torch_to_flax),
        "gdconv": (landmark_net.MobileNetGDConv, ref_gdconv, landmark_net.gdconv_reference_to_flax,
                   jax_lmk.gdconv_torch_to_flax),
    }


@pytest.mark.parametrize("name", sorted(_models()))
def test_converter_matches_jax(name):
    build, to_reference, port_conv, jax_conv_fn = _models()[name]
    model = build()
    model.reset_parameters(torch.Generator().manual_seed(19))
    sd = model.state_dict()
    ref = {k: t for k, t in to_reference(sd).items() if not k.endswith("num_batches_tracked")}
    if name == "resunet":
        ref = {"module." + k: t for k, t in ref.items()}    # a DDP prefix the loaders strip
    got, want = port_conv(ref), jax_conv_fn(ref)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    if name == "st_transformer":      # the identity patch embedding the converter supplies
        with torch.no_grad():
            model.patch_to_embedding.weight.copy_(torch.eye(48))
            model.patch_to_embedding.bias.zero_()
        sd = model.state_dict()
    back = flax_to_torch(got, model)
    for k, t in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k


def test_sub_to_normal_bn_matches_jax():
    rng = np.random.RandomState(20)
    sd = {"s1.bn.bn.running_mean": rng.randn(4), "s1.bn.bn.running_var": rng.rand(4),
          "s1.bn.bn.weight": rng.randn(4), "s1.bn.split_bn.running_mean": rng.randn(8),
          "s1.bn.weight": rng.randn(4, 1, 1, 1), "s1.bn.bias": rng.randn(4, 1, 1, 1),
          "s1.conv.weight": torch.from_numpy(rng.randn(4, 3, 1, 1, 1))}
    got, want = conv.sub_to_normal_bn(sd), jax_conv.sub_to_normal_bn(sd)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
