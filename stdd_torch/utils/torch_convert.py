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

The zoo's converters of that module (retinaface, resunet, ftcn, slowfast,
vit, resnet2d, ``sub_to_normal_bn``) wait for their models (ROADMAP.md §1
item 8).
"""

from __future__ import annotations

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
