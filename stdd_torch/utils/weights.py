"""Weight bridges: flax variable trees ↔ the port's ``state_dict``s.

The torch modules are named after the flax tree (``models/i3d.py``), so the
bridge is a name map plus layout changes:

- conv ``kernel`` ``[t,h,w,Cin,Cout]`` → ``conv.weight`` ``[Cout,Cin,t,h,w]``;
- ``bn/scale,bias`` → ``bn.weight,bias``; ``batch_stats .../bn/mean,var`` →
  ``bn.running_mean,running_var`` (eps stays ``cfg.bn_eps``, set on the
  module);
- ``head/projection/kernel`` ``[C,K]`` → ``head.projection.weight`` ``[K,C]``.

Every leaf must be consumed and every model entry produced: leftovers and
gaps raise. :func:`i3d_torch_to_flax` is the inverse, for writing the
trainer's checkpoint format from the port. :func:`i3d_opt_state_to_flax` and
:func:`i3d_opt_state_from_flax` carry the optimizer state (the momentum
trace or Adam's moments, and the counts) the same way.

The dual encoder's bridge (:func:`dual_flax_to_torch`,
:func:`dual_torch_to_flax`, for ``DualEncoderAU_LMK`` and ``LMKDisc``,
``models/dual_encoder.py``, and ``DualEncoderRGB``, ``models/dual_rgb.py``,
whose bias-free ``rgb_proj`` is one more ``Dense``) maps the params tree alone (the model has no
batch statistics): ``Dense`` kernels ``[in, out]`` → ``weight [out, in]``;
the attention's ``query``/``key``/``value`` kernels ``[D, H, D/H]`` and
biases ``[H, D/H]`` → ``[D, D]`` / ``[D]``, its ``out`` kernel
``[H, D/H, D]`` → ``[D, D]``; the depthwise ``temporal{i}`` kernels
``[3, 1, D]`` → ``[D, 1, 3]``; the ``pointwise`` 1-tap conv ``[1, D, D]`` →
a ``[D, D]`` weight; LayerNorm ``scale`` → ``weight``; the pooling query
``v`` as it is. :func:`dual_opt_state_to_flax` and
:func:`dual_opt_state_from_flax` carry the trainer's AdamW state (optax's
``mu``, ``nu`` and ``count``).

:func:`moe_flax_to_torch` and :func:`moe_torch_to_flax` carry the
``GatedMoE`` fusion head (``models/dual_rgb.py``): the scalar temperatures
``t_rgb``, ``t_dual`` as they are, the gate's ``Dense`` kernels transposed.

:func:`flax_to_torch` and :func:`torch_to_flax` carry every other module
named after its flax tree: the 2D conv nets of data production (the
landmarker's ``LandmarkNet``, whose pickle both packages read and write,
and the ``AUResNet18``) and the model zoo (``models/ftcn.py``,
``slowfast.py``, ``unet3d.py``, ``vit.py``, ``resnet2d.py``,
``retinaface.py``, ``landmark_net.py``): conv kernels DHWIO/HWIO ↔
OIDHW/OIHW, Dense kernels transposed, norm scales ↔ ``weight``, BatchNorm
statistics as above, other parameters (FTCN's ``cls_token`` …) by name.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _check_covers(out: Mapping, model: torch.nn.Module, what: str) -> None:
    """Raise unless ``out`` has exactly ``model.state_dict()``'s keys and
    shapes."""
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    bad = sorted(k for k in set(want) & set(out) if tuple(want[k].shape) != tuple(out[k].shape))
    if missing or extra or bad:
        raise ValueError(f"{what} do not match the model: missing={missing[:8]} "
                         f"extra={extra[:8]} shape_mismatch={bad[:8]}")


def i3d_flax_to_torch(variables, model: Optional[torch.nn.Module] = None
                      ) -> Dict[str, torch.Tensor]:
    """``variables``: ``{"params": ..., "batch_stats": ...}`` as nested
    mappings of numpy arrays (a flax ``FrozenDict`` works too). Returns the
    torch ``state_dict`` (float32 CPU tensors). With ``model``, the result
    is also checked key by key and shape by shape against
    ``model.state_dict()``; any missing or extra entry raises."""
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for coll in variables:
        if coll not in ("params", "batch_stats"):
            leftover.append((coll,))
            continue
        for path, arr in _leaves(variables[coll]):
            mod, leaf = path[:-1], path[-1]
            name = ".".join(mod)
            t = torch.from_numpy(np.array(arr, np.float32))
            if coll == "params" and mod[-1:] == ("conv",) and leaf == "kernel" and t.ndim == 5:
                out[f"{name}.weight"] = t.permute(4, 3, 0, 1, 2).contiguous()
            elif coll == "params" and mod[-1:] == ("bn",) and leaf in _BN_PARAM:
                out[f"{name}.{_BN_PARAM[leaf]}"] = t
            elif coll == "batch_stats" and mod[-1:] == ("bn",) and leaf in _BN_STAT:
                out[f"{name}.{_BN_STAT[leaf]}"] = t
                if leaf == "mean":
                    out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            elif coll == "params" and mod == ("head", "projection") and leaf == "kernel":
                out[f"{name}.weight"] = t.t().contiguous()
            elif coll == "params" and mod == ("head", "projection") and leaf == "bias":
                out[f"{name}.bias"] = t
            else:
                leftover.append((coll,) + path)
    if leftover:
        raise ValueError(f"unconsumed flax leaves: {['/'.join(p) for p in leftover[:8]]}")
    if model is not None:
        _check_covers(out, model, "flax variables")
    return out


def i3d_torch_to_flax(state_dict: Mapping) -> Dict[str, dict]:
    """The inverse map: the port's ``state_dict`` → ``{"params": ...,
    "batch_stats": ...}`` as nested dicts of float32 numpy arrays (views of
    the tensors where no copy is needed: a transposed view keeps a
    broadcast tensor's zero strides), the tree the JAX trainer checkpoints
    (``num_batches_tracked`` has no flax leaf)."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    inv_param = {v: k for k, v in _BN_PARAM.items()}
    inv_stat = {v: k for k, v in _BN_STAT.items()}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().float().cpu().numpy()
        if mod[-1:] == ["conv"] and leaf == "weight" and a.ndim == 5:
            coll, name, a = "params", "kernel", a.transpose(2, 3, 4, 1, 0)
        elif mod[-1:] == ["bn"] and leaf in inv_param:
            coll, name = "params", inv_param[leaf]
        elif mod[-1:] == ["bn"] and leaf in inv_stat:
            coll, name = "batch_stats", inv_stat[leaf]
        elif mod == ["head", "projection"] and leaf in ("weight", "bias"):
            coll, name = "params", "kernel" if leaf == "weight" else "bias"
            a = a.T if leaf == "weight" else a
        else:
            raise ValueError(f"state_dict entry {key!r} has no flax leaf")
        node = out[coll]
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = a
    return out


# The optimizer chain's state (``train/optim.py``): a tuple with one dict per
# transform (a nested chain is a nested tuple), laid out as flax's
# ``to_state_dict`` writes optax's state; the per-parameter trees ("trace",
# "mu", "nu") are keyed by the port's parameter names here and by the flax
# tree in a checkpoint.
_OPT_TREES = ("trace", "mu", "nu")


def opt_state_to_flax(opt_state, params_to_flax: Callable[[Mapping], dict]) -> Dict[str, dict]:
    """The port's optimizer state → optax's state dict: ``{"0": {...},
    "1": {...}, ...}``, each parameter tree through ``params_to_flax``
    (float32), each ``count`` an int32 scalar."""
    out = {}
    for i, entry in enumerate(opt_state):
        if isinstance(entry, tuple):
            out[str(i)] = opt_state_to_flax(entry, params_to_flax)
            continue
        node = {}
        for key, v in entry.items():
            if key in _OPT_TREES:
                node[key] = params_to_flax(v)
            elif key == "count":
                node[key] = np.asarray(v, np.int32)
            elif key == "inner_state" and v == {}:
                node[key] = {}
            else:
                raise ValueError(f"optimizer state entry {i} has an unknown field {key!r}")
        out[str(i)] = node
    return out


def opt_state_from_flax(tree: Mapping, like, params_from_flax: Callable[[Mapping], dict]):
    """optax's state dict → the port's optimizer state, in the structure,
    dtypes and devices of ``like`` (the chain's ``init``); each parameter
    tree through ``params_from_flax``. A checkpoint of another chain (other
    transforms, other fields or other parameters) raises."""
    if sorted(tree, key=int) != [str(i) for i in range(len(like))]:
        raise ValueError(f"checkpoint opt_state has entries {sorted(tree)}, the optimizer "
                         f"{len(like)}")
    out = []
    for i, entry in enumerate(like):
        src = tree[str(i)]
        if isinstance(entry, tuple):
            out.append(opt_state_from_flax(src, entry, params_from_flax))
            continue
        if set(src) != set(entry):
            raise ValueError(f"opt_state entry {i}: checkpoint fields {sorted(src)}, "
                             f"optimizer fields {sorted(entry)}")
        node = {}
        for key, v in entry.items():
            if key in _OPT_TREES:
                got = params_from_flax(src[key])
                if set(got) != set(v) or any(got[k].shape != v[k].shape for k in v):
                    raise ValueError(f"opt_state entry {i} {key!r} does not match the "
                                     "model's parameters")
                node[key] = {k: got[k].to(device=t.device, dtype=t.dtype) for k, t in v.items()}
            elif key == "count":
                node[key] = int(np.asarray(src[key]))
            else:
                node[key] = {}
        out.append(node)
    return tuple(out)


def i3d_opt_state_to_flax(opt_state) -> Dict[str, dict]:
    """The I3D trainer's optimizer state → its ``opt_state`` checkpoint tree."""
    return opt_state_to_flax(opt_state, lambda t: i3d_torch_to_flax(t)["params"])


def i3d_opt_state_from_flax(tree: Mapping, like):
    """An I3D checkpoint's ``opt_state`` tree → the port's optimizer state."""
    return opt_state_from_flax(tree, like, lambda t: i3d_flax_to_torch({"params": t}))


# -- the dual encoder ---------------------------------------------------------------

_QKV = ("query", "key", "value")


def dual_flax_to_torch(params: Mapping, model: Optional[torch.nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """A ``DualEncoderAU_LMK`` / ``LMKDisc`` params tree (nested mappings of
    arrays, no ``"params"`` wrapper) → the port's ``state_dict`` (float32
    CPU tensors; float64 leaves stay float64). With ``model``, every key
    and shape is checked against ``model.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        mod, leaf = path[:-1], path[-1]
        a = np.asarray(arr)
        a = a.astype(np.float64 if a.dtype == np.float64 else np.float32)
        last = mod[-1] if mod else ""
        if leaf == "kernel":
            if last in _QKV:
                a = a.reshape(a.shape[0], -1).T
            elif last == "out":
                a = a.reshape(-1, a.shape[-1]).T
            elif last.startswith("temporal"):
                a = a.transpose(2, 1, 0)
            elif last == "pointwise":
                a = a[0].T
            else:
                a = a.T
            leaf = "weight"
        elif leaf == "bias" and last in _QKV:
            a = a.reshape(-1)
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "v"):
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(mod + (leaf,))] = torch.from_numpy(np.ascontiguousarray(a))
    if model is not None:
        _check_covers(out, model, "flax params")
    return out


def dual_torch_to_flax(state_dict: Mapping, heads: int) -> Dict[str, dict]:
    """The inverse of :func:`dual_flax_to_torch`: the port's ``state_dict``
    (or any ``{name: tensor}`` tree over its parameters, such as Adam's
    moments) → the flax params tree of numpy arrays (float32, float64 kept);
    ``heads`` splits the attention's ``[D, D]`` weights."""
    out: Dict[str, dict] = {}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        a = t.detach().cpu()
        a = (a if a.dtype == torch.float64 else a.float()).numpy()
        last = mod[-1] if mod else ""
        if leaf == "weight" and a.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            if last in _QKV:
                a = a.T.reshape(a.shape[1], heads, -1)
            elif last == "out":
                a = a.T.reshape(heads, -1, a.shape[0])
            elif last.startswith("temporal"):
                a = a.transpose(2, 1, 0)
            elif last == "pointwise":
                a = a.T[None]
            else:
                a = a.T
            leaf = "kernel"
        elif leaf == "bias" and last in _QKV:
            a = a.reshape(heads, -1)
        node = out
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = a
    return out


def dual_opt_state_to_flax(opt_state, heads: int) -> Dict[str, dict]:
    """The dual trainer's optimizer state → optax's state dict."""
    return opt_state_to_flax(opt_state, lambda t: dual_torch_to_flax(t, heads))


def dual_opt_state_from_flax(tree: Mapping, like):
    """optax's state dict of the dual trainer → the port's optimizer state."""
    return opt_state_from_flax(tree, like, dual_flax_to_torch)


_MOE_SCALARS = ("t_rgb", "t_dual")
_MOE_DENSE = ("gate_fc1", "gate_fc2")


def moe_flax_to_torch(params: Mapping, model: Optional[torch.nn.Module] = None
                      ) -> Dict[str, torch.Tensor]:
    """A ``GatedMoE`` params tree → the port's ``state_dict``; a leaf it
    does not know raises, and with ``model`` every key and shape is checked
    against ``model.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        a = np.asarray(arr)
        a = a.astype(np.float64 if a.dtype == np.float64 else np.float32)
        if len(path) == 1 and path[0] in _MOE_SCALARS:
            key = path[0]
        elif len(path) == 2 and path[0] in _MOE_DENSE and path[1] in ("kernel", "bias"):
            key = f"{path[0]}.{'weight' if path[1] == 'kernel' else 'bias'}"
            a = a.T if path[1] == "kernel" else a
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    if model is not None:
        _check_covers(out, model, "flax params")
    return out


def moe_torch_to_flax(state_dict: Mapping) -> Dict[str, dict]:
    """The inverse of :func:`moe_flax_to_torch` (numpy arrays, float32;
    float64 kept)."""
    out: Dict[str, dict] = {}
    for key, t in state_dict.items():
        a = t.detach().cpu()
        a = (a if a.dtype == torch.float64 else a.float()).numpy()
        if key in _MOE_SCALARS:
            out[key] = a
            continue
        mod, leaf = key.split(".")
        if mod not in _MOE_DENSE or leaf not in ("weight", "bias"):
            raise ValueError(f"unexpected GatedMoE entry {key}")
        out.setdefault(mod, {})["kernel" if leaf == "weight" else "bias"] = (
            a.T if leaf == "weight" else a)
    return out


# -- the zoo and the 2D conv nets: one naming rule --------------------------------

# a flax kernel's axes → a torch weight's, by rank: Conv3d DHWIO → OIDHW,
# Conv2d HWIO → OIHW, Conv1d WIO → OIW, Dense [in, out] → [out, in]
_KERNEL_TO_TORCH = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
_KERNEL_TO_FLAX = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}


def flax_to_torch(variables: Mapping, model: Optional[torch.nn.Module] = None,
                  what: str = "model") -> Dict[str, torch.Tensor]:
    """A flax variables tree (``{"params": ..., "batch_stats": ...}`` of
    numpy arrays) → the ``state_dict`` of a port module named after it, the
    flax path joined by ``.`` (a flax name with a literal ``/``, as FTCN's
    ``s2/pathway0_res0``, stays one module name): a ``kernel`` of rank 5, 4,
    3 or 2 → ``weight`` with the axes of Conv3d, Conv2d, Conv1d or Linear;
    ``scale`` (BatchNorm, LayerNorm) → ``weight``; ``batch_stats``
    ``mean``/``var`` → ``running_mean``/``running_var``; any other leaf
    (``bias``, ``cls_token``, ``pos_embedding`` …) keeps its name. With
    ``model``, every key and shape is checked against ``model.state_dict()``
    (``what`` names the tree in the error)."""
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for coll in variables:
        if coll not in ("params", "batch_stats"):
            leftover.append((coll,))
            continue
        for path, arr in _leaves(variables[coll]):
            mod, leaf = ".".join(path[:-1]), path[-1]
            a = np.array(arr, np.float32)
            if coll == "params" and leaf == "kernel" and a.ndim in _KERNEL_TO_TORCH:
                t = torch.from_numpy(np.ascontiguousarray(a.transpose(_KERNEL_TO_TORCH[a.ndim])))
                out[f"{mod}.weight"] = t
            elif coll == "params" and leaf != "kernel":
                out[f"{mod}.{_BN_PARAM.get(leaf, leaf)}".lstrip(".")] = torch.from_numpy(a)
            elif coll == "batch_stats" and leaf in _BN_STAT:
                out[f"{mod}.{_BN_STAT[leaf]}"] = torch.from_numpy(a)
                if leaf == "mean":
                    out[f"{mod}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            else:
                leftover.append((coll,) + path)
    if leftover:
        raise ValueError(f"unconsumed flax leaves of the {what}: "
                         f"{['/'.join(p) for p in leftover[:8]]}")
    if model is not None:
        _check_covers(out, model, f"{what} variables")
    return out


def torch_to_flax(state_dict: Mapping) -> Dict[str, dict]:
    """The inverse of :func:`flax_to_torch`: ``{"params": ...}``, and
    ``"batch_stats"`` where there are running statistics, of float32 numpy
    arrays. A ``weight`` of rank 1 is a norm's ``scale``; of a higher rank a
    ``kernel``. Any ``{name: tensor}`` tree over the parameters (an
    optimizer's moments) maps too."""
    out: Dict[str, dict] = {}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().cpu().float().numpy()
        coll, name = "params", leaf
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and a.ndim == 1:
            name = "scale"
        elif leaf == "weight":
            name, a = "kernel", a.transpose(_KERNEL_TO_FLAX[a.ndim])
        node = out.setdefault(coll, {})
        for m in (mod.split(".") if mod else ()):
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return out
