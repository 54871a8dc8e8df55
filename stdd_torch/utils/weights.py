"""Weight bridge: a flax I3D variables tree → the port's ``state_dict``.

The torch modules are named after the flax tree (``models/i3d.py``), so the
bridge is a name map plus layout changes:

- conv ``kernel`` ``[t,h,w,Cin,Cout]`` → ``conv.weight`` ``[Cout,Cin,t,h,w]``;
- ``bn/scale,bias`` → ``bn.weight,bias``; ``batch_stats .../bn/mean,var`` →
  ``bn.running_mean,running_var`` (eps stays ``cfg.bn_eps``, set on the
  module);
- ``head/projection/kernel`` ``[C,K]`` → ``head.projection.weight`` ``[K,C]``.

Every leaf must be consumed and every model entry produced: leftovers and
gaps raise.
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
