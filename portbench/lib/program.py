"""The program under test, as the benchmark builds it: the port's
``ClipScorer`` over the benchmark's weights. This is the only module of the
harness, with the traffic kinds, that imports the port."""

from __future__ import annotations

import dataclasses

import torch

from ..reference.i3d import NetSpec, net_spec
from .weights import make_i3d_params

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}

# the program's own lower-precision paths, the output check's controls
VARIANTS = ("int8",)


def i3d_config(model: dict):
    """The port's ``I3DConfig`` from a configuration file's ``model`` block."""
    from stdd_torch.config import I3DConfig

    names = {f.name for f in dataclasses.fields(I3DConfig)}
    kw = {}
    for k, v in model.items():
        if k not in names:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[k] = v
    return I3DConfig(**kw)


def build_scorer(config: dict, seed: int, device, variant=None):
    """→ (scorer, the weights it was handed, the layer shapes). The weights
    stay the benchmark's: the reference reads them after the window."""
    from stdd_torch.runtime.classifier import ClipScorer

    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the program has {VARIANTS}")
    spec: NetSpec = net_spec(config["model"])
    params = make_i3d_params(spec, seed, device)
    serving = config["serving"]
    scorer = ClipScorer(params, cfg=i3d_config(config["model"]),
                        dtype=DTYPES[serving["dtype"]], upload_format=serving["upload_format"],
                        device=device, int8=variant == "int8")
    return scorer, params, spec
