"""Clip-batch packing for the streaming engine (per-clip uniform downscale
into fixed-size zero-padded slots) and track packing for dense scoring (one
uniform scale per track); boxes and landmarks are rescaled to match (a
similarity fit absorbs a uniform scale exactly).

Own copy of ``stdd_tpu/runtime/packing.py`` without cv2: the I420 encoder
is numpy (bit-exact with cv2's ``COLOR_RGB2YUV_I420``) and the area resize
is the native C++ kernel (``stdd_torch/native``) or its numpy twin.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# BT.601 video-range RGB→YUV in Q20 fixed point, as OpenCV's
# RGB2YUV420p conversion (ITUR_BT_601_* constants)
_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448


def _get(e, k):
    return e[k] if isinstance(e, dict) else getattr(e, k)


def pow2_capacities(max_batch: int):
    """All batch capacities a dispatch group can ship: powers of two below
    ``max_batch`` plus ``max_batch`` itself."""
    caps, c = [], 1
    while c < max_batch:
        caps.append(c)
        c *= 2
    caps.append(max_batch)
    return tuple(caps)


def upload_format_of(scorer) -> str:
    """The pack format a scorer expects (single source of truth for every
    pack call site)."""
    return getattr(scorer, "upload_format", "rgb")


def rgb_to_i420(rgb: np.ndarray, out: np.ndarray) -> None:
    """RGB uint8 [H, W, 3] (even sides) → planar I420 in ``out``, a
    contiguous array of H*W*3//2 bytes in any shape (the engine's slots are
    [S*3//2, S] with S % 4 == 0): the Y plane, then U and V at quarter size.
    Bit-exact with ``cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)``: Q20 BT.601
    video range, chroma taken from the top-left pixel of each 2×2 block."""
    H, W = rgb.shape[:2]
    flat = out.reshape(-1)
    if not np.may_share_memory(flat, out) or flat.size != H * W * 3 // 2:
        raise ValueError(f"rgb_to_i420: out must be a contiguous buffer of {H * W * 3 // 2} "
                         f"bytes, got shape {out.shape}")
    c = rgb.astype(np.int32)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = (_CRY * r + _CGY * g + _CBY * b + (_HALF + (16 << _SHIFT))) >> _SHIFT
    n, q = H * W, (H // 2) * (W // 2)
    flat[:n] = y.reshape(-1)
    r2, g2, b2 = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = (_CRU * r2 + _CGU * g2 + _CBU * b2 + (_HALF + (128 << _SHIFT))) >> _SHIFT
    v = (_CBU * r2 + _CGV * g2 + _CBV * b2 + (_HALF + (128 << _SHIFT))) >> _SHIFT
    flat[n:n + q] = np.clip(u, 0, 255).reshape(-1)
    flat[n + q:] = np.clip(v, 0, 255).reshape(-1)


def _encode_slot_yuv420(e, rgb_slot: np.ndarray, s: float, out: np.ndarray):
    """Pack one entry through a reused RGB slot, then I420-encode into
    ``out`` [S*3//2, S]; → (scaled box, scaled lm5)."""
    rgb_slot[:] = 0
    box, lm5 = _pack_entry(e, rgb_slot, s)
    rgb_to_i420(rgb_slot, out)
    return box, lm5


def _area_resize_np(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Exact area-average downscale (cv2.INTER_AREA semantics) in pure
    numpy: fractional source boxes are summed exactly by bilinear-sampling
    the integral image (piecewise bilinear for a piecewise-constant image)."""
    h, w = img.shape[:2]
    a = img.astype(np.float64).reshape(h, w, -1)
    cs = np.zeros((h + 1, w + 1, a.shape[2]), np.float64)
    cs[1:, 1:] = a.cumsum(0).cumsum(1)
    ys = np.linspace(0.0, float(h), oh + 1)
    xs = np.linspace(0.0, float(w), ow + 1)

    def integral_at(y: np.ndarray, x: np.ndarray) -> np.ndarray:
        yi = np.minimum(np.floor(y).astype(int), h - 1) if h else np.zeros_like(y, int)
        xi = np.minimum(np.floor(x).astype(int), w - 1) if w else np.zeros_like(x, int)
        fy = (y - yi)[:, None, None]
        fx = (x - xi)[None, :, None]
        c00 = cs[yi][:, xi]
        c01 = cs[yi][:, xi + 1]
        c10 = cs[yi + 1][:, xi]
        c11 = cs[yi + 1][:, xi + 1]
        return (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
                + c10 * fy * (1 - fx) + c11 * fy * fx)

    F = integral_at(ys, xs)
    box = F[1:, 1:] - F[:-1, 1:] - F[1:, :-1] + F[:-1, :-1]
    area = (ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :]
    out = box / area[..., None]
    out = np.clip(np.rint(out), 0, 255).astype(img.dtype)
    return out.reshape((oh, ow) + img.shape[2:])


def _pack_entry(e, dst_slot: np.ndarray, s: float) -> Tuple[np.ndarray, np.ndarray]:
    """Write one entry's crop into a zero-padded S×S slot at uniform scale
    ``s`` (native area resize, numpy twin without a compiler); →
    (scaled box, scaled lm5)."""
    c = _get(e, "crop")
    if s < 1.0:
        from ..native import resize_area_pack

        if not resize_area_pack(c, dst_slot, s):
            h, w = c.shape[:2]
            oh = min(max(1, int(h * s)), dst_slot.shape[0])
            ow = min(max(1, int(w * s)), dst_slot.shape[1])
            dst_slot[:oh, :ow] = _area_resize_np(c, oh, ow)
    else:
        h, w = c.shape[:2]
        dst_slot[:h, :w] = c
    return (np.asarray(_get(e, "big_box"), np.float32) * s,
            np.asarray(_get(e, "lm5"), np.float32) * s)


def pack_clip_batch(
    clips: Sequence[Sequence],       # per clip: items with .crop/.big_box/.lm5 or dicts
    batch_capacity: int,
    T: int,
    S: int,
    yuv420: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """→ (crops [B,T,S,S,3] u8 (or I420 [B,T,S*3//2,S]), boxes [B,T,4] f32,
    lm5 [B,T,5,2] f32, valid [B] bool); short clips are padded by repeating
    the last frame (TEST2.py:358-363)."""
    if yuv420 and S % 4:
        raise ValueError("yuv420 packing needs S divisible by 4")
    crops = np.zeros(
        (batch_capacity, T) + ((S * 3 // 2, S) if yuv420 else (S, S, 3)), np.uint8
    )
    boxes = np.zeros((batch_capacity, T, 4), np.float32)
    lm5 = np.zeros((batch_capacity, T, 5, 2), np.float32)
    valid = np.zeros((batch_capacity,), bool)
    rgb_slot = np.zeros((S, S, 3), np.uint8) if yuv420 else None

    for bi, entries in enumerate(clips[:batch_capacity]):
        entries = list(entries)
        while len(entries) < T:
            entries = entries + [entries[-1]]
        max_dim = max(
            max(_get(e, "crop").shape[0], _get(e, "crop").shape[1]) for e in entries
        )
        s = min(1.0, S / float(max_dim))
        for ti, e in enumerate(entries[:T]):
            if yuv420:
                boxes[bi, ti], lm5[bi, ti] = _encode_slot_yuv420(
                    e, rgb_slot, s, crops[bi, ti]
                )
            else:
                boxes[bi, ti], lm5[bi, ti] = _pack_entry(e, crops[bi, ti], s)
        valid[bi] = True
    return crops, boxes, lm5, valid


def pack_track(entries: Sequence, S: int, yuv420: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack ONE track's frames (items with .crop/.big_box/.lm5, or dicts)
    into a buffer for ``ClipScorer.score_dense`` at a single uniform scale
    for the whole track → (frames [N,S,S,3] uint8, or planar I420
    [N,S*3//2,S] with ``yuv420``; boxes [N,4]; lm5 [N,5,2])."""
    if yuv420 and S % 4:
        raise ValueError("yuv420 packing needs S divisible by 4")
    N = len(entries)
    frames = np.zeros((N,) + ((S * 3 // 2, S) if yuv420 else (S, S, 3)), np.uint8)
    boxes = np.zeros((N, 4), np.float32)
    lm5 = np.zeros((N, 5, 2), np.float32)
    max_dim = max(max(_get(e, "crop").shape[0], _get(e, "crop").shape[1]) for e in entries)
    s = min(1.0, S / float(max_dim))
    rgb_slot = np.zeros((S, S, 3), np.uint8) if yuv420 else None
    for i, e in enumerate(entries):
        if yuv420:
            boxes[i], lm5[i] = _encode_slot_yuv420(e, rgb_slot, s, frames[i])
        else:
            boxes[i], lm5[i] = _pack_entry(e, frames[i], s)
    return frames, boxes, lm5
