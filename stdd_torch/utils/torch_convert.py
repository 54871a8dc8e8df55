"""Reference PyTorch checkpoints → flax-layout variable trees, which the
port's weight bridge (``utils/weights.py``) takes in.

Port of the I3D and dual-encoder part of ``stdd_tpu/utils/torch_convert.py``.
The reference stores I3D checkpoints as ``{"classifier": state_dict, ...}``
(or a bare state dict) with keys like
``resnet.s2.pathway0_res0.branch2.a.weight``, and strips wrapper prefixes
tolerantly (reference ``model/_base.py:39``); the maps here do the same.

Layout conversions (as in the JAX module):

- Conv3d ``[O, I, T, H, W]`` → flax ``[T, H, W, I, O]``;
- Linear ``[O, I]`` → flax ``[I, O]``;
- BatchNorm weight/bias → scale/bias; running_mean/var → batch_stats
  mean/var.

Names: the port's ``utils/weights.py`` already has ``i3d_torch_to_flax`` and
``dual_torch_to_flax``, which map the PORT's modules to flax. The JAX
functions of those names map a REFERENCE state dict; here they are
:func:`i3d_reference_to_flax` and :func:`dual_reference_to_flax`.
:func:`i3d_torch_to_reference` is the other direction, the port's I3D
``state_dict`` written with the reference's keys, so the port can produce a
file in the format it loads.

The zoo's converters (:func:`retinaface_reference_to_flax`,
:func:`sub_to_normal_bn`, :func:`resunet_reference_to_flax`,
:func:`ftcn_reference_to_flax`, :func:`slowfast_reference_to_flax`,
:func:`videoit_reference_to_flax`, :func:`st_transformer_reference_to_flax`,
:func:`resnet2d_reference_to_flax`) map the reference's state dicts onto the
flax trees of ``stdd_tpu/models``, which ``utils/weights.py::flax_to_torch``
carries onto the port's modules of the same names. Each mirrors the JAX
function named ``*_torch_to_flax``; the GDConv landmarker's is
``models/landmark_net.py::gdconv_reference_to_flax``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _strip_prefixes(key: str) -> str:
    for pre in ("module.", "model.", "classifier.", "resnet."):
        if key.startswith(pre):
            key = key[len(pre):]
    return key


def _numpy(val) -> np.ndarray:
    return np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val)


def i3d_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference I3D state dict → ``{"params": …, "batch_stats": …}`` as
    nested dicts of numpy arrays. Mirrors ``stdd_tpu/utils/torch_convert.py
    ::i3d_torch_to_flax``: ``branch1`` → ``shortcut/conv``, ``branch1_bn`` →
    ``shortcut/bn``, ``a`` → ``a/conv``, ``a_bn`` → ``a/bn`` (likewise ``b``,
    ``c``); ``num_batches_tracked`` is dropped; any other leaf raises."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, val in state_dict.items():
        key = _strip_prefixes(key)
        if key.endswith("num_batches_tracked"):
            continue
        arr = _numpy(val)
        *mods, leaf = key.split(".")
        path = []
        for m in mods:
            if m == "branch1":
                path += ["shortcut", "conv"]
            elif m == "branch1_bn":
                path += ["shortcut", "bn"]
            elif m in ("a", "b", "c") and leaf == "weight" and arr.ndim == 5:
                path += [m, "conv"]
            elif m in ("a_bn", "b_bn", "c_bn"):
                path += [m[0], "bn"]
            else:
                path.append(m)
        path = tuple(path)

        if arr.ndim == 5 and leaf == "weight":          # conv kernel
            _set(params, path + ("kernel",), arr.transpose(2, 3, 4, 1, 0))
        elif arr.ndim == 2 and leaf == "weight":        # linear
            _set(params, path + ("kernel",), arr.T)
        elif leaf == "weight":                           # bn scale
            _set(params, path + ("scale",), arr)
        elif leaf == "bias":
            _set(params, path + ("bias",), arr)
        elif leaf == "running_mean":
            _set(stats, path + ("mean",), arr)
        elif leaf == "running_var":
            _set(stats, path + ("var",), arr)
        else:
            raise KeyError(f"unhandled checkpoint key: {key}")
    return {"params": params, "batch_stats": stats}


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference ``.pth`` and convert it with
    :func:`i3d_reference_to_flax`, unwrapping the trainer's
    ``{"classifier": …}`` and a ``{"state_dict": …}`` (reference
    model/_base.py:56-95). The file is unpickled (``weights_only=False``, as
    the JAX loader reads it): load only checkpoints you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "classifier" in obj:
        obj = obj["classifier"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return i3d_reference_to_flax(obj)


# the port's I3D module names → the reference's (the inverse of the renames
# in i3d_reference_to_flax)
_TO_REFERENCE = {("shortcut", "conv"): "branch1", ("shortcut", "bn"): "branch1_bn",
                 **{(m, "conv"): m for m in "abc"}, **{(m, "bn"): f"{m}_bn" for m in "abc"}}


def i3d_torch_to_reference(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's I3D ``state_dict`` under the reference's keys
    (``resnet.s2.pathway0_res0.branch2.a.weight``, ``….a_bn.running_mean``,
    ``….branch1.weight``, ``resnet.s1.pathway0_stem.conv.weight``,
    ``resnet.head.projection.weight``): a dict that
    :func:`i3d_reference_to_flax`, and the JAX converter, read back to the
    tree the port's bridge gives."""
    out = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        if len(mods) >= 2 and tuple(mods[-2:]) in _TO_REFERENCE:
            mods = mods[:-2] + [_TO_REFERENCE[tuple(mods[-2:])]]
        out[".".join(["resnet"] + mods + [leaf])] = t
    return out


def dual_reference_to_flax(state_dict: Mapping[str, Any], heads: int = 4) -> Dict[str, Any]:
    """A reference ``DualEncoderAU_LMK`` state dict (dualrun/model/
    dual_encoder.py) → ``{"params": …}``, the flax tree
    :func:`~stdd_torch.utils.weights.dual_flax_to_torch` takes. Mirrors
    ``stdd_tpu/utils/torch_convert.py::dual_torch_to_flax``."""
    params: Dict[str, Any] = {}

    def put(path, v):
        _set(params, tuple(path.split("/")), v)

    sd = {k: _numpy(v) for k, v in state_dict.items()}
    d_model = sd["au_enc.proj.weight"].shape[0]
    head_dim = d_model // heads

    for branch in ("au_enc", "lmk_enc"):
        put(f"{branch}/proj/kernel", sd[f"{branch}.proj.weight"].T)
        put(f"{branch}/proj/bias", sd[f"{branch}.proj.bias"])
        put(f"{branch}/ln_in/scale", sd[f"{branch}.ln_in.weight"])
        put(f"{branch}/ln_in/bias", sd[f"{branch}.ln_in.bias"])
        for i in range(3):
            w = sd[f"{branch}.temporal.{i}.weight"]  # [D,1,3] depthwise
            put(f"{branch}/temporal{i}/kernel", w.transpose(2, 1, 0))
            put(f"{branch}/temporal{i}/bias", sd[f"{branch}.temporal.{i}.bias"])
        put(f"{branch}/pointwise/kernel", sd[f"{branch}.pointwise.weight"].transpose(2, 1, 0))
        put(f"{branch}/pointwise/bias", sd[f"{branch}.pointwise.bias"])
        put(f"{branch}/pool/v", sd[f"{branch}.pool.v"])
        li = 0
        while f"{branch}.encoder.layers.{li}.norm1.weight" in sd:
            pre = f"{branch}.encoder.layers.{li}"
            out = f"{branch}/layer{li}"
            ipw = sd[f"{pre}.self_attn.in_proj_weight"]
            ipb = sd[f"{pre}.self_attn.in_proj_bias"]
            for j, name in enumerate(("query", "key", "value")):
                w = ipw[j * d_model: (j + 1) * d_model]  # [D, D]
                b = ipb[j * d_model: (j + 1) * d_model]
                put(f"{out}/self_attn/{name}/kernel", w.T.reshape(d_model, heads, head_dim))
                put(f"{out}/self_attn/{name}/bias", b.reshape(heads, head_dim))
            ow = sd[f"{pre}.self_attn.out_proj.weight"]  # [D, D]
            put(f"{out}/self_attn/out/kernel", ow.T.reshape(heads, head_dim, d_model))
            put(f"{out}/self_attn/out/bias", sd[f"{pre}.self_attn.out_proj.bias"])
            put(f"{out}/linear1/kernel", sd[f"{pre}.linear1.weight"].T)
            put(f"{out}/linear1/bias", sd[f"{pre}.linear1.bias"])
            put(f"{out}/linear2/kernel", sd[f"{pre}.linear2.weight"].T)
            put(f"{out}/linear2/bias", sd[f"{pre}.linear2.bias"])
            for n in ("norm1", "norm2"):
                put(f"{out}/{n}/scale", sd[f"{pre}.{n}.weight"])
                put(f"{out}/{n}/bias", sd[f"{pre}.{n}.bias"])
            li += 1

    put("head_ln/scale", sd["head.0.weight"])
    put("head_ln/bias", sd["head.0.bias"])
    put("head_fc1/kernel", sd["head.1.weight"].T)
    put("head_fc1/bias", sd["head.1.bias"])
    put("head_fc2/kernel", sd["head.4.weight"].T)
    put("head_fc2/bias", sd["head.4.bias"])
    put("au_from_lmk_ln/scale", sd["au_from_lmk.0.weight"])
    put("au_from_lmk_ln/bias", sd["au_from_lmk.0.bias"])
    put("au_from_lmk_fc/kernel", sd["au_from_lmk.1.weight"].T)
    put("au_from_lmk_fc/bias", sd["au_from_lmk.1.bias"])
    put("proj_au/kernel", sd["proj_au.weight"].T)
    put("proj_au/bias", sd["proj_au.bias"])
    put("proj_lmk/kernel", sd["proj_lmk.weight"].T)
    put("proj_lmk/bias", sd["proj_lmk.bias"])
    if "domain_head.weight" in sd:
        put("domain_head/kernel", sd["domain_head.weight"].T)
        put("domain_head/bias", sd["domain_head.bias"])
    return {"params": params}


# -- the model zoo ------------------------------------------------------------------

def retinaface_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference RetinaFace (mobilenet0.25) state dict
    (test_tools/ct/detection/alignment.py) → the flax tree of
    ``models/retinaface.py::RetinaFace``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    sd = {k: _numpy(v) for k, v in state_dict.items()}

    def put_conv(dst, key):
        # [O, I/g, H, W] → [H, W, I/g, O] (depthwise convolutions too)
        _set(params, tuple(dst.split("/")) + ("kernel",), sd[key + ".weight"].transpose(2, 3, 1, 0))
        if key + ".bias" in sd:
            _set(params, tuple(dst.split("/")) + ("bias",), sd[key + ".bias"])

    def put_bn(dst, key):
        path = tuple(dst.split("/"))
        _set(params, path + ("scale",), sd[key + ".weight"])
        _set(params, path + ("bias",), sd[key + ".bias"])
        _set(stats, path + ("mean",), sd[key + ".running_mean"])
        _set(stats, path + ("var",), sd[key + ".running_var"])

    put_conv("body/s1_conv/conv", "body.stage1.0.0")
    put_bn("body/s1_conv/bn", "body.stage1.0.1")
    for stage, idxs, prefix in (("stage1", range(1, 6), "s1_dw"), ("stage2", range(0, 6), "s2_dw"),
                                ("stage3", range(0, 2), "s3_dw")):
        for n, i in enumerate(idxs):
            base, dst = f"body.{stage}.{i}", f"body/{prefix}{n}"
            put_conv(f"{dst}/dw/conv", base + ".0")
            put_bn(f"{dst}/dw/bn", base + ".1")
            put_conv(f"{dst}/pw/conv", base + ".3")
            put_bn(f"{dst}/pw/bn", base + ".4")
    for k in (1, 2, 3):
        put_conv(f"fpn/output{k}/conv", f"fpn.output{k}.0")
        put_bn(f"fpn/output{k}/bn", f"fpn.output{k}.1")
    for k in (1, 2):
        put_conv(f"fpn/merge{k}/conv", f"fpn.merge{k}.0")
        put_bn(f"fpn/merge{k}/bn", f"fpn.merge{k}.1")
    # the reference's mixed-case names (conv7x7_3 is lower-case there)
    ssh_names = {"conv3x3": "conv3X3", "conv5x5_1": "conv5X5_1", "conv5x5_2": "conv5X5_2",
                 "conv7x7_2": "conv7X7_2", "conv7x7_3": "conv7x7_3"}
    for s in (1, 2, 3):
        for dst_n, src_n in ssh_names.items():
            put_conv(f"ssh{s}/{dst_n}/conv", f"ssh{s}.{src_n}.0")
            put_bn(f"ssh{s}/{dst_n}/bn", f"ssh{s}.{src_n}.1")
    for i in range(3):
        put_conv(f"class_head{i}", f"ClassHead.{i}.conv1x1")
        put_conv(f"bbox_head{i}", f"BboxHead.{i}.conv1x1")
        put_conv(f"ldm_head{i}", f"LandmarkHead.{i}.conv1x1")
    return {"params": params, "batch_stats": stats}


def sub_to_normal_bn(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Sub-BatchNorm checkpoint keys → plain BN keys before a conversion
    (reference slowfast/utils/checkpoint.py:340): ``bn.bn.running_*`` →
    ``bn.running_*``, ``bn.split_bn.*`` and other ``bn.bn.*`` dropped, 4-d
    BN affine parameters squeezed."""
    new_sd: Dict[str, Any] = {}
    for key, val in state_dict.items():
        if ".split_bn." in key:
            continue
        k = key
        for before, after in (("bn.bn.running_mean", "bn.running_mean"),
                              ("bn.bn.running_var", "bn.running_var")):
            if k.endswith(before):
                k = k[: -len(before)] + after
        if "bn.bn." in k:
            continue
        arr = _numpy(val)
        if (k.endswith("bn.weight") or k.endswith("bn.bias")) and arr.ndim == 4:
            arr = arr[:, 0, 0, 0]
        new_sd[k] = arr
    return new_sd


def resunet_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference ResUNet* state dict (video_model_builder.py:1128-2742) →
    the flax tree of ``models/unet3d.py::ResUNet3D``: the encoder by the I3D
    naming; ``t{4,3}_{label}.conv{1,2}.{0,1}`` → ``Conv_0``/``BatchNorm_0``
    (the residual decoders' ``branch1``/``a``/``b``/``c`` pass through);
    ``conv1x1_{label}.{0,1,3}`` → ``conv1``/``bn``/``conv2``; ``linear.0`` →
    ``linear``."""
    renamed: Dict[str, Any] = {}
    for key, val in state_dict.items():
        k = _strip_prefixes(key)
        parts = k.split(".")
        head = parts[0]
        if head.startswith(("t4_", "t3_")) and parts[2] in ("0", "1"):
            parts[2] = {"0": "Conv_0", "1": "BatchNorm_0"}[parts[2]]
            k = ".".join(parts)
        elif head.startswith("conv1x1_"):
            k = ".".join([parts[0], {"0": "conv1", "1": "bn", "3": "conv2"}[parts[1]]] + parts[2:])
        elif head == "linear" and parts[1] == "0":
            k = ".".join([parts[0]] + parts[2:])
        renamed[k] = val
    return i3d_reference_to_flax(renamed)


_VIT_LINEARS = {"to_qkv": "qkv{i}", "to_out.0": "attn_out{i}", "net.0": "mlp_fc1_{i}",
                "net.3": "mlp_fc2_{i}"}


def _vit_layer_path(rest: str):
    """One reference Transformer layer key tail (``layers.{i}.{0|1}.fn.
    (norm|fn....)``) → (our module name, leaf, transpose?)."""
    m = re.match(r"layers\.(\d+)\.(\d)\.fn\.(.+)$", rest)
    if not m:
        raise KeyError(rest)
    i, half, body = m.group(1), m.group(2), m.group(3)
    if body.startswith("norm."):
        return (("attn_norm" if half == "0" else "mlp_norm") + i,
                "scale" if body.endswith("weight") else "bias", False)
    lin, leaf = body[len("fn."):].rsplit(".", 1)
    return _VIT_LINEARS[lin].format(i=i), ("kernel" if leaf == "weight" else "bias"), \
        leaf == "weight"


def _dense(params: Dict[str, Any], path: Tuple[str, ...], key: str, a: np.ndarray) -> None:
    """A torch Linear's weight or bias at ``path`` as flax's kernel/bias."""
    w = key.endswith("weight")
    _set(params, path + ("kernel" if w else "bias",), a.T if w else a)


def _norm(params: Dict[str, Any], path: Tuple[str, ...], key: str, a: np.ndarray) -> None:
    _set(params, path + ("scale" if key.endswith("weight") else "bias",), a)


def ftcn_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference FTCN state dict (``I3D8x8`` of
    i3d_temporal_var_fix_dropout_tt_cfg.py: the mutated temporal-only
    ResNet + TransformerHead) → the flax tree of ``models/ftcn.py::FTCN``.
    A strided conv's BN sits in ``Sequential(bn, MaxPool)`` (a ``.0``
    segment); ``branch1``/``branch2.{a,b,c}`` land under
    ``{shortcut,a,b,c}/Conv3dBN_0``; the blocks' flax name keeps its literal
    slash (``s2/pathway0_res0`` is one key); the head's
    ``Residual(PreNorm(…))`` nesting flattens onto ``attn_*``/``mlp_*``/
    ``head_*``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, val in state_dict.items():
        k = _strip_prefixes(key)
        if k.endswith("num_batches_tracked"):
            continue
        a = _numpy(val)
        if k.startswith("head."):
            h = k[len("head."):]
            if h.startswith("fc."):
                _dense(params, ("head", "proj"), h, a)
            elif h in ("time_T.cls_token", "time_T.pos_embedding"):
                _set(params, ("head", h.split(".")[1]), a)
            elif h.startswith("time_T.mlp_head.0."):
                _norm(params, ("head", "head_norm"), h, a)
            elif h.startswith("time_T.mlp_head.1."):
                _dense(params, ("head", "head_fc"), h, a)
            elif h.startswith("time_T.transformer."):
                name, leaf, tr = _vit_layer_path(h[len("time_T.transformer."):])
                _set(params, ("head", name, leaf), a.T if tr else a)
            else:
                raise KeyError(f"unhandled FTCN head key: {key}")
            continue
        m = re.match(r"(s\d)\.pathway0_stem\.(conv|bn)(?:\.0)?\.(.+)$", k)
        if m:
            base = (m.group(1), "Conv3dBN_0")
            mod, leaf = m.group(2), m.group(3)
        else:
            m = re.match(r"(s\d)\.(pathway0_res\d+)\.(.+)$", k)
            if not m:
                raise KeyError(f"unhandled FTCN trunk key: {key}")
            parts = m.group(3).split(".")
            if parts[0] == "branch2":
                parts = parts[1:]
            name = parts[0]
            if name == "branch1":
                sub, mod = "shortcut", "conv"
            elif name == "branch1_bn":
                sub, mod = "shortcut", "bn"
            elif name.endswith("_bn"):
                sub, mod = name[0], "bn"
            else:
                sub, mod = name, "conv"
            parts = parts[1:]
            if parts and parts[0] == "0":     # the Sequential(bn, pool) wrapper
                parts = parts[1:]
            base = (f"{m.group(1)}/{m.group(2)}", sub, "Conv3dBN_0")
            leaf = ".".join(parts)
        if mod == "conv" and leaf == "weight":
            _set(params, base + ("conv", "kernel"), a.transpose(2, 3, 4, 1, 0))
        elif mod == "bn" and leaf in ("weight", "bias"):
            _set(params, base + ("bn", "scale" if leaf == "weight" else "bias"), a)
        elif mod == "bn" and leaf in ("running_mean", "running_var"):
            _set(stats, base + ("bn", leaf[len("running_"):]), a)
        else:
            raise KeyError(f"unhandled FTCN trunk key: {key}")
    return {"params": params, "batch_stats": stats}


def slowfast_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference SlowFast state dict (video_model_builder.py:147) → the
    flax tree of ``models/slowfast.py::SlowFast``: pathway 0/1 into the
    ``*_slow``/``*_fast`` pairs, the lateral fusions' conv and BN into
    ``s*_fuse/conv_f2s``, ``head.projection`` into ``projection``; the rest
    by the I3D naming."""
    renamed: Dict[str, Any] = {}
    for key, val in state_dict.items():
        k = _strip_prefixes(key)
        m = re.match(r"(s\d)\.pathway([01])_(stem|res\d+)\.(.+)$", k)
        if m:
            side = "slow" if m.group(2) == "0" else "fast"
            k = f"{m.group(1)}_{side}.pathway0_{m.group(3)}.{m.group(4)}"
        elif re.match(r"s\d_fuse\.conv_f2s\.", k):
            k = k.replace(".conv_f2s.", ".conv_f2s.conv.")
        elif re.match(r"s\d_fuse\.bn\.", k):
            k = k.replace(".bn.", ".conv_f2s.bn.")
        elif k.startswith("head.projection."):
            k = k[len("head."):]
        renamed[k] = val
    return i3d_reference_to_flax(renamed)


def videoit_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference VideoiT (time_transformer.py:167) → the flax params of
    ``models/vit.py::VideoiT``."""
    params: Dict[str, Any] = {}
    for key, val in state_dict.items():
        a = _numpy(val)
        if key in ("cls_token", "pos_embedding"):
            _set(params, (key,), a)
        elif key.startswith("patch_to_embedding."):
            _dense(params, ("patch_to_embedding",), key, a)
        elif key.startswith("mlp_head.0."):
            _norm(params, ("head_norm",), key, a)
        elif key.startswith("mlp_head.1."):
            _dense(params, ("mlp_head",), key, a)
        elif key.startswith("transformer."):
            name, leaf, tr = _vit_layer_path(key[len("transformer."):])
            _set(params, ("transformer", name, leaf), a.T if tr else a)
        else:
            raise KeyError(f"unhandled VideoiT key: {key}")
    return {"params": params}


def st_transformer_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference SpatialTemporal_Transformer (time_transformer.py:281) →
    the flax params of ``models/vit.py::SpatialTemporalTransformer``. The
    reference has no patch-embedding Linear (its raw 3·p² patches must equal
    ``dim``), so the explicit projection gets the identity."""
    params: Dict[str, Any] = {}
    dim = None
    for key, val in state_dict.items():
        a = _numpy(val)
        if key in ("space_token", "temporal_token", "pos_embedding"):
            _set(params, (key,), a)
            dim = a.shape[-1]
        elif key.startswith("mlp_head.0."):
            _norm(params, ("head_norm",), key, a)
        elif key.startswith("mlp_head.1."):
            _dense(params, ("mlp_head",), key, a)
        elif key.startswith(("space_transformer.", "temporal_transformer.")):
            mod, rest = key.split(".", 1)
            name, leaf, tr = _vit_layer_path(rest)
            _set(params, (mod, name, leaf), a.T if tr else a)
        else:
            raise KeyError(f"unhandled ST-transformer key: {key}")
    if dim is None:
        raise KeyError("no space_token, temporal_token or pos_embedding: not an ST-transformer")
    _set(params, ("patch_to_embedding", "kernel"), np.eye(dim, dtype=np.float32))
    _set(params, ("patch_to_embedding", "bias"), np.zeros((dim,), np.float32))
    return {"params": params}


def resnet2d_reference_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference 2D ResNet (torchvision layout, ``_resnet_base.py``) →
    the flax tree of ``models/resnet2d.py::ResNet2D``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put_bn(base, leaf, a):
        if leaf in ("weight", "bias"):
            _set(params, base + ("scale" if leaf == "weight" else "bias",), a)
        elif leaf in ("running_mean", "running_var"):
            _set(stats, base + (leaf[len("running_"):],), a)
        else:
            raise KeyError(leaf)

    for key, val in state_dict.items():
        k = _strip_prefixes(key)
        if k.endswith("num_batches_tracked"):
            continue
        a = _numpy(val)
        if k == "conv1.weight":
            _set(params, ("conv1", "kernel"), a.transpose(2, 3, 1, 0))
        elif k.startswith("bn1."):
            put_bn(("bn1",), k.split(".", 1)[1], a)
        elif k.startswith("fc."):
            _dense(params, ("fc",), k, a)
        else:
            m = re.match(r"layer(\d)\.(\d+)\.(.+)$", k)
            if not m:
                raise KeyError(f"unhandled resnet2d key: {key}")
            blk = f"layer{m.group(1)}_{m.group(2)}"
            rest = m.group(3).split(".")
            if rest[0].startswith("conv"):
                _set(params, (blk, rest[0], "Conv_0", "kernel"), a.transpose(2, 3, 1, 0))
            elif rest[0].startswith("bn"):
                put_bn((blk, "conv" + rest[0][2:], "BatchNorm_0"), rest[1], a)
            elif rest[0] == "downsample" and rest[1] == "0":
                _set(params, (blk, "downsample", "Conv_0", "kernel"), a.transpose(2, 3, 1, 0))
            elif rest[0] == "downsample":
                put_bn((blk, "downsample", "BatchNorm_0"), rest[2], a)
            else:
                raise KeyError(f"unhandled resnet2d key: {key}")
    return {"params": params, "batch_stats": stats}
