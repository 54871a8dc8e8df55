"""Plain FTCN-TT eval forward, float32, for the benchmark's output check.

FTCN-TT (Zheng et al., "Exploring Temporal Coherence for More General Video
Face Forgery Detection", ICCV 2021; the published ``config/ftcn_tt.yaml``)
as AltFreezing's ``i3d_temporal_var_fix_dropout_tt_cfg`` builds it, written
from the configuration file's layer shapes alone with plain
``torch.nn.functional`` calls. It imports nothing of the program under test.

- Stem: the I3D-R50 stem with its spatial kernel collapsed to 1x1, a
  ``[t0, 1, 1]`` convolution at the full crop, batch norm, then the
  ``MaxPool(1, 2, 2)`` that stands in for the removed spatial stride, ReLU,
  and the stem's own ``1x3x3`` max pool (stride 2).
- Trunk: the stages before ``s{stop_point}`` (s2-s4 for 5) of bottleneck
  blocks whose three convolutions are ``[kt, 1, 1]``, ``[1, 1, 1]`` and
  ``[1, 1, 1]``, each followed by batch norm (its running statistics as a
  per-channel affine); a block's spatial stride of 2 becomes a
  ``MaxPool(1, 2, 2)`` after the batch norm of its middle convolution and
  of its projection shortcut. A ``[t, 1, 1]`` max pool follows s2.
- Head: the spatial mean gives one token per time step; a cls token in
  front, a positional embedding added, then ``depth`` pre-norm encoder
  layers (multi-head self-attention with a bias-free qkv projection, an
  MLP), a LayerNorm of the cls token (the features) and a linear layer to
  the logits.

Departures from the published PyTorch FTCN, each the program's:

- GELU is the tanh approximation and LayerNorm's epsilon is 1e-6, the JAX
  rebuild's constants, which the port serves; the published code has the
  exact GELU and 1e-5. The reference follows the served constants, so that
  the check compares one piece of mathematics.
- Eval only: no dropout, no random patch selection.

Parameters are a flat mapping of names to float32 tensors, named as the
served model's state dict (``s2/pathway0_res0.a.Conv3dBN_0.conv.weight``,
``head.qkv0.weight`` ...), the interface the benchmark hands the same
weights through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import align
from .i3d import STAGE_DEPTH, _temp_kernels


@dataclasses.dataclass(frozen=True)
class TConv:
    """A ``[kt, 1, 1]`` convolution (stride 1) followed by batch norm and,
    with ``pool``, the ``MaxPool(1, 2, 2)`` of a removed spatial stride."""
    name: str                      # prefix of its parameters
    cin: int
    cout: int
    kt: int
    pool: bool = False
    residual_end: bool = False     # the last BN of a residual branch


@dataclasses.dataclass(frozen=True)
class Block:
    a: TConv
    b: TConv
    c: TConv
    shortcut: Optional[TConv]


@dataclasses.dataclass(frozen=True)
class Head:
    tokens: int                    # time tokens, the cls token not counted
    dim: int
    depth: int
    heads: int
    dim_head: int
    mlp_dim: int
    num_classes: int
    ln_eps: float


@dataclasses.dataclass(frozen=True)
class FTCNSpec:
    stem: TConv
    stages: Tuple[Tuple[Block, ...], ...]
    t_pool_after_s2: int
    head: Head
    frames: int
    crop: int


def net_spec(model: dict, head: dict) -> FTCNSpec:
    """The layer shapes of a configuration file's ``model`` and ``head``
    blocks. The head's width and token count follow from the trunk; where
    the head block states them, they must agree."""
    if not model.get("temporal_only"):
        raise ValueError("FTCN-TT is the temporal-only trunk: the model block needs "
                         "temporal_only true")
    depths = STAGE_DEPTH[model["depth"]]
    w = model["width_per_group"]
    inner = model["num_groups"] * w
    tk = model["temp_kernel"]
    stem = TConv("s1.Conv3dBN_0", model["input_channels"], w, tk[0][0], pool=True)
    n_stages = max(1, min(4, model["stop_point"] - 2))
    stages: List[Tuple[Block, ...]] = []
    dim_in = w
    for s in range(n_stages):
        dim_out, dim_inner = w * 4 * 2 ** s, inner * 2 ** s
        temps = _temp_kernels(tk[s + 1], depths[s], model["num_block_temp_kernel"][s])
        blocks = []
        for i in range(depths[s]):
            pool = i == 0 and model["spatial_strides"][s] == 2
            bi = dim_in if i == 0 else dim_out
            p = f"s{s + 2}/pathway0_res{i}"
            a = TConv(f"{p}.a.Conv3dBN_0", bi, dim_inner, temps[i])
            b = TConv(f"{p}.b.Conv3dBN_0", dim_inner, dim_inner, 1, pool=pool)
            c = TConv(f"{p}.c.Conv3dBN_0", dim_inner, dim_out, 1, residual_end=True)
            sc = (TConv(f"{p}.shortcut.Conv3dBN_0", bi, dim_out, 1, pool=pool)
                  if bi != dim_out or pool else None)
            blocks.append(Block(a, b, c, sc))
        stages.append(tuple(blocks))
        dim_in = dim_out
    tp = model["t_pool_after_s2"] if n_stages > 1 else 1
    if head.get("patch_type", "time") != "time":
        raise ValueError("the reference builds the time-token head only")
    hd = Head(tokens=model["num_frames"] // tp, dim=dim_in, depth=head["depth"],
              heads=head["heads"], dim_head=head["dim_head"], mlp_dim=head["mlp_dim"],
              num_classes=model["num_classes"], ln_eps=head.get("ln_eps", 1e-6))
    for key, want in (("dim", hd.dim), ("time_tokens", hd.tokens)):
        if key in head and head[key] != want:
            raise ValueError(f"the head block's {key} {head[key]} is not the trunk's {want}")
    return FTCNSpec(stem, tuple(stages), tp, hd, model["num_frames"], model["crop_size"])


def tconvs(spec: FTCNSpec) -> Iterator[TConv]:
    yield spec.stem
    for stage in spec.stages:
        for blk in stage:
            yield blk.a
            yield blk.b
            yield blk.c
            if blk.shortcut is not None:
                yield blk.shortcut


def head_shapes(hd: Head) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the head, by name (``head.`` prefix), with its shape."""
    inner = hd.heads * hd.dim_head
    out = {"head.cls_token": (1, 1, hd.dim), "head.pos_embedding": (1, hd.tokens + 1, hd.dim)}
    for i in range(hd.depth):
        out.update({
            f"head.attn_norm{i}.weight": (hd.dim,), f"head.attn_norm{i}.bias": (hd.dim,),
            f"head.qkv{i}.weight": (3 * inner, hd.dim),
            f"head.attn_out{i}.weight": (hd.dim, inner), f"head.attn_out{i}.bias": (hd.dim,),
            f"head.mlp_norm{i}.weight": (hd.dim,), f"head.mlp_norm{i}.bias": (hd.dim,),
            f"head.mlp_fc1_{i}.weight": (hd.mlp_dim, hd.dim),
            f"head.mlp_fc1_{i}.bias": (hd.mlp_dim,),
            f"head.mlp_fc2_{i}.weight": (hd.dim, hd.mlp_dim), f"head.mlp_fc2_{i}.bias": (hd.dim,),
        })
    out.update({"head.head_norm.weight": (hd.dim,), "head.head_norm.bias": (hd.dim,),
                "head.head_fc.weight": (hd.num_classes, hd.dim),
                "head.head_fc.bias": (hd.num_classes,)})
    return out


def _tconv(p: Dict[str, torch.Tensor], tc: TConv, x: torch.Tensor, eps: float):
    y = F.conv3d(x, p[tc.name + ".conv.weight"], None, 1, (tc.kt // 2, 0, 0))
    g = p[tc.name + ".bn.weight"]
    scale = g / torch.sqrt(p[tc.name + ".bn.running_var"] + eps)
    shift = p[tc.name + ".bn.bias"] - p[tc.name + ".bn.running_mean"] * scale
    y = y * scale.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1)
    if tc.pool:
        y = F.max_pool3d(y, (1, 2, 2), (1, 2, 2))
    return y


def head_forward(p: Dict[str, torch.Tensor], hd: Head, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tokens`` [B, N, D] → (logits [B, C], the normed cls token [B, D])."""
    B = tokens.shape[0]

    def ln(x, name):
        return F.layer_norm(x, (hd.dim,), p[name + ".weight"], p[name + ".bias"], hd.ln_eps)

    x = torch.cat([p["head.cls_token"].expand(B, 1, hd.dim), tokens], 1)
    x = x + p["head.pos_embedding"]
    for i in range(hd.depth):
        h = ln(x, f"head.attn_norm{i}")
        q, k, v = (h @ p[f"head.qkv{i}.weight"].t()).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, -1, hd.heads, hd.dim_head).transpose(1, 2) for t in (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd.dim_head), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(B, -1, hd.heads * hd.dim_head)
        x = x + o @ p[f"head.attn_out{i}.weight"].t() + p[f"head.attn_out{i}.bias"]
        h = ln(x, f"head.mlp_norm{i}")
        h = F.gelu(h @ p[f"head.mlp_fc1_{i}.weight"].t() + p[f"head.mlp_fc1_{i}.bias"],
                   approximate="tanh")
        x = x + h @ p[f"head.mlp_fc2_{i}.weight"].t() + p[f"head.mlp_fc2_{i}.bias"]
    feats = ln(x[:, 0], "head.head_norm")
    return feats @ p["head.head_fc.weight"].t() + p["head.head_fc.bias"], feats


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, spec: FTCNSpec,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [B, 3, T, H, W] normalized float32 → (logits [B, C], the normed
    cls token [B, D]), in ``x``'s dtype."""
    x = F.relu(_tconv(params, spec.stem, x, eps))
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    for s, stage in enumerate(spec.stages):
        for blk in stage:
            br = F.relu(_tconv(params, blk.a, x, eps))
            br = F.relu(_tconv(params, blk.b, br, eps))
            br = _tconv(params, blk.c, br, eps)
            sc = _tconv(params, blk.shortcut, x, eps) if blk.shortcut is not None else x
            x = F.relu(sc + br)
        if s == 0 and spec.t_pool_after_s2 > 1:
            tp = spec.t_pool_after_s2
            x = F.max_pool3d(x, (tp, 1, 1), (tp, 1, 1))
    tokens = x.mean(dim=(3, 4)).transpose(1, 2)                 # [B, T', C]
    return head_forward(params, spec.head, tokens)


def logits_and_features(params: Dict[str, torch.Tensor], spec: FTCNSpec,
                        windows: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                        eps: float, device) -> Tuple[np.ndarray, np.ndarray]:
    """``windows``: (I420 frames [T, 3S/2, S] uint8, big boxes [T, 4],
    crop-local landmarks [T, 5, 2]) each, one at a time (the stem's output
    of one 32x224x224 window is 411 MB in float32) → (logits [N, C],
    features [N, D]) as float64 numpy. TF32 is off for the convolutions
    and products, and restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logits, feats = [], []
    try:
        with torch.no_grad():
            for frames, boxes, lm5 in windows:
                rgb = align.i420_to_rgb(torch.as_tensor(np.asarray(frames), device=device))
                x = align.normalize(align.align_clip(rgb, boxes, lm5, spec.crop))
                lg, ft = forward(params, x.float().permute(3, 0, 1, 2)[None], spec, eps)
                logits.append(lg[0].double().cpu().numpy())
                feats.append(ft[0].double().cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return np.stack(logits), np.stack(feats)
