"""Plain I3D-ResNet forward, float32, for the benchmark's output check.

The network of SlowFast's ``I3D_8x8_R50`` trunk as AltFreezing serves it,
written from the configuration file's layer shapes alone with plain
``torch.nn.functional`` calls: conv3d without bias, batch norm in eval
(its running statistics as a per-channel affine), ReLU, max pools, the
mean over time and space, a linear head. It imports nothing of the
program under test.

Parameters are a flat mapping of names to float32 tensors. The names are
those of the served model's state dict (``s2.pathway0_res0.branch2.a.conv.weight``
...), which is the interface the benchmark hands the same weights through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# ImageNet mean and standard deviation on the 0..255 scale
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One convolution followed by batch norm."""
    name: str                      # prefix of its parameters
    cin: int
    cout: int
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int]
    pad: Tuple[int, int, int]
    residual_end: bool = False     # the last BN of a residual branch


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    name: str
    a: ConvSpec
    b: ConvSpec
    c: ConvSpec
    shortcut: "ConvSpec | None"


@dataclasses.dataclass(frozen=True)
class NetSpec:
    stem: ConvSpec
    stages: Tuple[Tuple[BlockSpec, ...], ...]
    t_pool_after_s2: int
    head_in: int
    num_classes: int
    frames: int
    crop: int


def _temp_kernels(basis, blocks: int, n_temp: int) -> Tuple[int, ...]:
    """A stage's temporal kernels: the basis tiled, cut to ``n_temp``
    blocks, the rest 1 (SlowFast resnet_helper's rule)."""
    tiled = (tuple(basis) * blocks)[:n_temp]
    return tiled + (1,) * (blocks - n_temp)


def net_spec(cfg: dict) -> NetSpec:
    """The layer shapes of a configuration file's ``model`` block."""
    depths = STAGE_DEPTH[cfg["depth"]]
    w = cfg["width_per_group"]
    inner = cfg["num_groups"] * w
    tk = cfg["temp_kernel"]
    t0 = tk[0][0]
    stem = ConvSpec("s1.pathway0_stem", cfg["input_channels"], w, (t0, 7, 7), (1, 2, 2),
                    (t0 // 2, 3, 3))
    if cfg.get("temporal_only"):
        raise ValueError("the reference builds the full I3D trunk only")
    stages: List[Tuple[BlockSpec, ...]] = []
    dim_in = w
    for s in range(len(depths)):
        name = f"s{s + 2}"
        dim_out, dim_inner = w * 4 * 2 ** s, inner * 2 ** s
        temps = _temp_kernels(tk[s + 1], depths[s], cfg["num_block_temp_kernel"][s])
        blocks = []
        for i in range(depths[s]):
            stride = cfg["spatial_strides"][s] if i == 0 else 1
            bi = dim_in if i == 0 else dim_out
            p = f"{name}.pathway0_res{i}"
            t = temps[i]
            a = ConvSpec(f"{p}.branch2.a", bi, dim_inner, (t, 1, 1), (1, 1, 1), (t // 2, 0, 0))
            b = ConvSpec(f"{p}.branch2.b", dim_inner, dim_inner, (1, 3, 3),
                         (1, stride, stride), (0, 1, 1))
            c = ConvSpec(f"{p}.branch2.c", dim_inner, dim_out, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                         residual_end=True)
            sc = None
            if bi != dim_out or stride != 1:
                sc = ConvSpec(f"{p}.shortcut", bi, dim_out, (1, 1, 1), (1, stride, stride),
                              (0, 0, 0))
            blocks.append(BlockSpec(p, a, b, c, sc))
        stages.append(tuple(blocks))
        dim_in = dim_out
    return NetSpec(stem, tuple(stages), cfg["t_pool_after_s2"], dim_in, cfg["num_classes"],
                   cfg["num_frames"], cfg["crop_size"])


def conv_specs(spec: NetSpec) -> Iterator[ConvSpec]:
    yield spec.stem
    for stage in spec.stages:
        for blk in stage:
            yield blk.a
            yield blk.b
            yield blk.c
            if blk.shortcut is not None:
                yield blk.shortcut


def _conv_bn(p: Dict[str, torch.Tensor], cs: ConvSpec, x: torch.Tensor, eps: float):
    y = F.conv3d(x, p[cs.name + ".conv.weight"], None, cs.stride, cs.pad)
    g = p[cs.name + ".bn.weight"]
    scale = g / torch.sqrt(p[cs.name + ".bn.running_var"] + eps)
    shift = p[cs.name + ".bn.bias"] - p[cs.name + ".bn.running_mean"] * scale
    return y * scale.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, spec: NetSpec,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [B, 3, T, H, W] normalized float32 → (logits [B, C], pooled
    features [B, D]), in ``x``'s dtype."""
    x = F.relu(_conv_bn(params, spec.stem, x, eps))
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    for s, stage in enumerate(spec.stages):
        for blk in stage:
            br = F.relu(_conv_bn(params, blk.a, x, eps))
            br = F.relu(_conv_bn(params, blk.b, br, eps))
            br = _conv_bn(params, blk.c, br, eps)
            sc = _conv_bn(params, blk.shortcut, x, eps) if blk.shortcut is not None else x
            x = F.relu(sc + br)
        if s == 0 and spec.t_pool_after_s2 > 1:
            tp = spec.t_pool_after_s2
            x = F.max_pool3d(x, (tp, 1, 1), (tp, 1, 1), (0, 0, 0))
    feats = x.mean(dim=(2, 3, 4))
    logits = feats @ params["head.projection.weight"].t() + params["head.projection.bias"]
    return logits, feats
