"""Checkpoints in the JAX trainer's format: epoch-indexed msgpack trees with
GC, resume and a tolerant partial merge.

Own copy of ``stdd_tpu/utils/checkpoint.py`` over the port's msgpack codec
(``utils/msgpack.py``), so a checkpoint written by either package is read by
the other:

- ``{name}_{epoch}.msgpack`` with ``max_to_keep`` GC (``protect=`` spares
  the best epoch) and :func:`find_last` resume (reference
  model/_base.py:28-116 ModelBase);
- :func:`tolerant_merge`: key-prefix stripping and shape-filtered merging
  (model/_base.py:56-95), with the same report;
- the ``{path}.json`` sidecar of training metadata.

Trees are nested dicts of numpy arrays or torch tensors; lists and tuples
are written as flax writes them, as dicts keyed ``"0"``, ``"1"``, …
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .msgpack import msgpack_restore, msgpack_serialize


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` for plain containers (string keys, lists and
    tuples as index-keyed dicts) over leaves made arrays as the JAX
    ``save_checkpoint`` makes them (``np.asarray``; torch tensors stay
    tensors, so bfloat16 is kept)."""
    if isinstance(tree, Mapping):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree)


def save_checkpoint(directory: str, name: str, epoch: int, tree: Any, max_to_keep: int = 5,
                    metadata: Optional[Dict] = None, protect: Optional[str] = None) -> str:
    """Write ``{directory}/{name}_{epoch}.msgpack`` (and its ``.json``
    sidecar when ``metadata`` is given), then keep the newest
    ``max_to_keep`` epochs. The GC never deletes the file just written, nor
    the one named ``protect`` (the best-validation epoch)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}_{epoch}.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_serialize(_state_dict(tree)))
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=1, default=str)
    if max_to_keep and max_to_keep > 0:
        for _, p in list_checkpoints(directory, name)[:-max_to_keep]:
            if os.path.abspath(p) == os.path.abspath(path):
                continue
            if protect and os.path.basename(p) == protect:
                continue
            try:
                os.remove(p)
                if os.path.exists(p + ".json"):
                    os.remove(p + ".json")
            except OSError:
                pass
    return path


def list_checkpoints(directory: str, name: str) -> List[Tuple[int, str]]:
    """``(epoch, path)`` of every ``{name}_{epoch}.msgpack``, oldest first."""
    out = []
    for p in glob.glob(os.path.join(directory, f"{name}_*.msgpack")):
        m = re.match(rf".*{re.escape(name)}_(\d+)\.msgpack$", p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def find_last(directory: str, name: str) -> Optional[Tuple[int, str]]:
    """Latest epoch checkpoint (ModelBase.find_last)."""
    found = list_checkpoints(directory, name)
    return found[-1] if found else None


def load_checkpoint(path: str) -> Any:
    """The checkpoint's tree: nested dicts of numpy arrays (``torch.bfloat16``
    tensors for bfloat16 leaves)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _unflatten(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return root


def tolerant_merge(target: Any, source: Any, strip_prefixes: Tuple[str, ...] = ()
                   ) -> Tuple[Dict[str, Any], Dict[str, List[str]]]:
    """Merge ``source`` leaves into ``target`` wherever path and shape
    match; leaves take the target's dtype. Returns the merged tree (numpy
    leaves) and the report ``{"loaded", "missing", "unexpected",
    "shape_mismatch"}`` of ``/``-joined paths (the reference's tolerant
    loader, model/_base.py:56-95)."""
    tgt = {k: _as_numpy(v) for k, v in _flatten(target).items()}
    src = _flatten(source)

    def strip(path: Tuple[str, ...]) -> Tuple[str, ...]:
        while path and path[0] in strip_prefixes:
            path = path[1:]
        return path

    src = {strip(k): v for k, v in src.items()}
    report: Dict[str, List[str]] = {"loaded": [], "missing": [], "unexpected": [],
                                    "shape_mismatch": []}
    merged = dict(tgt)
    for path, v in src.items():
        if path not in tgt:
            report["unexpected"].append("/".join(path))
            continue
        v = _as_numpy(v)
        if v.shape != tgt[path].shape:
            report["shape_mismatch"].append("/".join(path))
            continue
        merged[path] = np.asarray(v, dtype=tgt[path].dtype)
        report["loaded"].append("/".join(path))
    for path in tgt:
        if path not in src:
            report["missing"].append("/".join(path))
    return _unflatten(merged), report
