"""FTCN-TT's work, counted from a configuration's shapes, never from a trace.

:func:`ftcn_flops`: the model FLOPs of one window, 2 per multiply-add,
over every convolution at the resolution it runs at (before the max pool
that stands in for its removed spatial stride) and the head's matrix
products (qkv, the attention's two products, its output projection, the
MLP and the last linear layer, over the cls token and every time token).
Batch norm, ReLU, the pools, the means, LayerNorm, GELU and softmax are not
counted, as ``lib/flops.py`` leaves them out of the I3D's count.
"""

from __future__ import annotations

from ..reference.ftcn import FTCNSpec, Head, TConv


def _conv(tc: TConv, thw):
    """(FLOPs, the output's (T, H, W) after the pool, if any)."""
    t, h, w = thw
    flops = 2 * tc.cout * tc.cin * tc.kt * t * h * w
    return flops, (t, h // 2, w // 2) if tc.pool else thw


def head_flops(hd: Head) -> int:
    n = hd.tokens + 1
    inner = hd.heads * hd.dim_head
    macs = hd.depth * (n * hd.dim * 3 * inner              # qkv
                       + 2 * hd.heads * n * n * hd.dim_head  # q k^T, att v
                       + n * inner * hd.dim                  # output projection
                       + 2 * n * hd.dim * hd.mlp_dim)        # the MLP's two layers
    return 2 * (macs + hd.dim * hd.num_classes)


def ftcn_flops(spec: FTCNSpec) -> int:
    """FLOPs of one [T, S, S] window through the network of ``spec``."""
    total, thw = _conv(spec.stem, (spec.frames, spec.crop, spec.crop))
    thw = (thw[0], (thw[1] - 1) // 2 + 1, (thw[2] - 1) // 2 + 1)      # the stem's max pool
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
            thw = (thw[0] // spec.t_pool_after_s2, thw[1], thw[2])
    return total + head_flops(spec.head)
