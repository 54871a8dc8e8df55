"""Weight bridge: a flax I3D variables tree ↔ the port's ``state_dict``.

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
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

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
        want = model.state_dict()
        missing = sorted(set(want) - set(out))
        extra = sorted(set(out) - set(want))
        bad = sorted(k for k in set(want) & set(out) if tuple(want[k].shape) != tuple(out[k].shape))
        if missing or extra or bad:
            raise ValueError(
                f"flax variables do not match the model: missing={missing[:8]} "
                f"extra={extra[:8]} shape_mismatch={bad[:8]}")
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


# The optimizer chain's state (``train/engine_i3d.py``): a tuple with one
# dict per transform, laid out as flax's ``to_state_dict`` writes optax's
# state; the per-parameter trees ("trace", "mu", "nu") are keyed by the
# port's parameter names here and by the flax tree in a checkpoint.
_OPT_TREES = ("trace", "mu", "nu")


def i3d_opt_state_to_flax(opt_state) -> Dict[str, dict]:
    """The port's optimizer state → the JAX trainer's ``opt_state`` tree:
    ``{"0": {...}, "1": {...}, ...}`` with flax-named parameter trees
    (float32) and int32 ``count`` scalars."""
    out = {}
    for i, entry in enumerate(opt_state):
        node = {}
        for key, v in entry.items():
            if key in _OPT_TREES:
                node[key] = i3d_torch_to_flax(v)["params"]
            elif key == "count":
                node[key] = np.asarray(v, np.int32)
            elif key == "inner_state" and v == {}:
                node[key] = {}
            else:
                raise ValueError(f"optimizer state entry {i} has an unknown field {key!r}")
        out[str(i)] = node
    return out


def i3d_opt_state_from_flax(tree: Mapping, like):
    """A checkpoint's ``opt_state`` tree → the port's optimizer state, in
    the structure, dtypes and devices of ``like`` (the chain's ``init``).
    A checkpoint of another chain (other transforms, other fields or other
    parameters) raises."""
    if sorted(tree, key=int) != [str(i) for i in range(len(like))]:
        raise ValueError(f"checkpoint opt_state has entries {sorted(tree)}, the optimizer "
                         f"{len(like)}")
    out = []
    for i, entry in enumerate(like):
        src = tree[str(i)]
        if set(src) != set(entry):
            raise ValueError(f"opt_state entry {i}: checkpoint fields {sorted(src)}, "
                             f"optimizer fields {sorted(entry)}")
        node = {}
        for key, v in entry.items():
            if key in _OPT_TREES:
                got = i3d_flax_to_torch({"params": src[key]})
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

