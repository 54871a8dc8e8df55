"""Work counted from a configuration's shapes, never from a trace.

- :func:`i3d_flops`: the model FLOPs of one window, 2 per multiply-add, over
  every convolution (stem, each bottleneck's a/b/c and its shortcut) and the
  head. Batch norm, ReLU, pools and the mean are not counted. The count
  follows the layer shapes of the configuration file, so it does not change
  when a later change fuses, folds or replaces a kernel.
- :func:`k1_bytes_per_frame`: what the clip warp (K1) must move for one
  frame: read the planar I420 uint8 crop and the frame's 8 float32 warp
  parameters once, write the aligned frame once in the forward's input
  dtype (bf16).
"""

from __future__ import annotations

from typing import Tuple

from ..reference.i3d import ConvSpec, NetSpec

# published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W)
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(cs: ConvSpec, thw: Tuple[int, int, int]) -> Tuple[int, Tuple[int, int, int]]:
    out = tuple(_out(n, k, s, p) for n, k, s, p in zip(thw, cs.kernel, cs.stride, cs.pad))
    macs = cs.cout * cs.cin * cs.kernel[0] * cs.kernel[1] * cs.kernel[2] * out[0] * out[1] * out[2]
    return 2 * macs, out


def i3d_flops(spec: NetSpec) -> int:
    """FLOPs of one [T, S, S] window through the network of ``spec``."""
    total, thw = _conv(spec.stem, (spec.frames, spec.crop, spec.crop))
    thw = (thw[0], _out(thw[1], 3, 2, 1), _out(thw[2], 3, 2, 1))       # stem max pool
    for s, stage in enumerate(spec.stages):
        for blk in stage:
            fa, ta = _conv(blk.a, thw)
            fb, tb = _conv(blk.b, ta)
            fc, tc = _conv(blk.c, tb)
            total += fa + fb + fc
            if blk.shortcut is not None:
                total += _conv(blk.shortcut, thw)[0]
            thw = tc
        if s == 0 and spec.t_pool_after_s2 > 1:
            tp = spec.t_pool_after_s2
            thw = (_out(thw[0], tp, tp, 0), thw[1], thw[2])
    return total + 2 * spec.head_in * spec.num_classes


def k1_bytes_per_frame(crop_buffer: int, out_size: int) -> int:
    return crop_buffer * crop_buffer * 3 // 2 + 8 * 4 + out_size * out_size * 3 * 2
