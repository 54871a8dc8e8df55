"""Plain clip preparation for the benchmark's output check, float64.

What the served scorer does to a window before its network, written again
from the published semantics and not from the program:

- planar I420 → RGB: BT.601 video range, chroma repeated over each 2x2
  block (OpenCV's ``COLOR_YUV2RGB_I420`` without its final rounding);
- the clip's union canvas: each frame's big box offset from the clip's
  top-left corner, landmarks moved into the canvas;
- ONE similarity per clip from all frames' 5-point landmarks to the
  template: MATLAB ``cp2tform``'s non-reflective least squares (solved
  here with ``numpy.linalg.lstsq``), and its reflective choice as the
  reference's Python port makes it, scoring both candidates against the
  x-negated template (the port aliases the array it negates);
- every frame warped with that similarity (the inverse map, then the
  frame's canvas offset, then the frame's pack scale), bilinear, zero
  outside the crop;
- ImageNet normalisation.

For the live path it also packs a frame's crop as the ring does: a uniform
area-average downscale into the top-left of a zero S×S slot, then RGB →
I420 (BT.601 video range, chroma from each 2x2 block's top-left pixel).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .i3d import IMAGENET_MEAN, IMAGENET_STD

# the 5-point template of a 256-pixel crop (eyes, nose tip, mouth corners),
# as the reference aligner defines it
TEMPLATE_256 = np.array([[85.82991, 85.7792], [169.0532, 84.3381], [127.574, 137.0006],
                         [90.6964, 174.7014], [167.3069, 173.3733]])


def i420_to_rgb(planar: torch.Tensor) -> torch.Tensor:
    """[..., 3S/2, S] uint8 → [..., S, S, 3] float64 in 0..255."""
    S = planar.shape[-1]
    h = S // 2
    p = planar.double()
    y = p[..., :S, :]
    u = p[..., S:S + S // 4, :].reshape(planar.shape[:-2] + (h, h))
    v = p[..., S + S // 4:, :].reshape(planar.shape[:-2] + (h, h))
    u = u.repeat_interleave(2, -1).repeat_interleave(2, -2) - 128.0
    v = v.repeat_interleave(2, -1).repeat_interleave(2, -2) - 128.0
    yl = 1.164 * (y - 16.0)
    rgb = torch.stack([yl + 1.596 * v, yl - 0.391 * u - 0.813 * v, yl + 2.018 * u], -1)
    return rgb.clamp(0.0, 255.0)


def _nonreflective(uv: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """cp2tform's findNonreflectiveSimilarity: the 3x3 row-vector matrix T
    with [u v 1] T ≈ [x y 1], fitted as the inverse map xy → uv."""
    x, y = xy[:, 0], xy[:, 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    X = np.concatenate([np.stack([x, y, one, zero], 1), np.stack([y, -x, zero, one], 1)])
    U = np.concatenate([uv[:, 0], uv[:, 1]])
    sc, ss, tx, ty = np.linalg.lstsq(X, U, rcond=None)[0]
    tinv = np.array([[sc, -ss, 0.0], [ss, sc, 0.0], [tx, ty, 1.0]])
    return np.linalg.inv(tinv)


def similarity_2x3(uv: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """The reference's get_similarity_transform_for_cv2 (reflective): the
    2x3 forward affine uv → xy."""
    t1 = _nonreflective(uv, xy)
    xy_neg = xy * np.array([-1.0, 1.0])
    t2 = _nonreflective(uv, xy_neg) @ np.diag([-1.0, 1.0, 1.0])

    def fwd(t):
        return uv @ t[:2, :2] + t[2, :2]

    n1 = np.linalg.norm(fwd(t1) - xy_neg)
    n2 = np.linalg.norm(fwd(t2) - xy_neg)
    t = t1 if n1 <= n2 else t2
    return t[:, :2].T


def _area_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] float64: the share of each source pixel in each output
    pixel of an area-average resize (fractional pixels weighed by their
    coverage)."""
    edges = torch.arange(n_out + 1, dtype=torch.float64, device=device) * (n_in / n_out)
    px = torch.arange(n_in, dtype=torch.float64, device=device)[None, :]
    cover = (torch.minimum(edges[1:, None], px + 1)
             - torch.maximum(edges[:-1, None], px)).clamp(min=0)
    return cover / cover.sum(1, keepdim=True)


def area_resize(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Area-average resize of a uint8 [h, w, C] image to [oh, ow, C],
    rounded to the nearest integer."""
    h, w, c = img.shape
    rows = _area_weights(h, oh, img.device) @ img.double().reshape(h, w * c)     # [oh, w*c]
    out = rows.reshape(oh, w, c).transpose(1, 2) @ _area_weights(w, ow, img.device).T
    return torch.round(out.transpose(1, 2)).clamp(0, 255).to(torch.uint8)


def rgb_to_i420(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [S, S, 3] RGB → planar I420 [3S/2, S] uint8."""
    S = rgb.shape[0]
    c = rgb.double()
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256
    r2, g2, b2 = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = 128 + (-37.945 * r2 - 74.494 * g2 + 112.439 * b2) / 256
    v = 128 + (112.439 * r2 - 94.154 * g2 - 18.285 * b2) / 256

    def q(t):
        return torch.round(t).clamp(0, 255).to(torch.uint8)

    return torch.cat([q(y), q(u).reshape(S // 4, S), q(v).reshape(S // 4, S)])


def pack_crop(frame_bgr: np.ndarray, big_box: np.ndarray, S: int, device="cpu"
              ) -> Tuple[torch.Tensor, float]:
    """A frame's big-box crop as the live ring stores it: (I420 slot
    [3S/2, S] uint8 on ``device``, its scale)."""
    x1, y1, x2, y2 = (int(v) for v in big_box)
    crop = torch.as_tensor(np.ascontiguousarray(frame_bgr[y1:y2, x1:x2, ::-1]), device=device)
    h, w = crop.shape[:2]
    s = min(1.0, S / float(max(h, w)))
    slot = torch.zeros((S, S, 3), dtype=torch.uint8, device=device)
    if s < 1.0:
        oh, ow = min(max(1, int(h * s)), S), min(max(1, int(w * s)), S)
        slot[:oh, :ow] = area_resize(crop, oh, ow)
    else:
        slot[:h, :w] = crop
    return rgb_to_i420(slot), s


def align_clip(rgb: torch.Tensor, boxes: np.ndarray, lm5: np.ndarray, out: int,
               scale: "np.ndarray | None" = None) -> torch.Tensor:
    """``rgb`` [T, H, W, 3] float64 crops, ``boxes`` [T, 4] big boxes,
    ``lm5`` [T, 5, 2] crop-local landmarks (both unscaled), ``scale`` [T]
    the crops' pack scales (1 when None) → [T, out, out, 3] float64."""
    boxes = np.asarray(boxes, np.float64)
    lm5 = np.asarray(lm5, np.float64)
    diffs = boxes[:, :2] - boxes[:, :2].min(0)
    pts = (lm5 + diffs[:, None, :]).reshape(-1, 2)
    tpl = np.tile(TEMPLATE_256 * (out / 256.0), (len(boxes), 1))
    A = np.vstack([similarity_2x3(pts, tpl), [0.0, 0.0, 1.0]])
    Ainv = np.linalg.inv(A)[:2]
    dev = rgb.device
    T, H, W, _ = rgb.shape
    r, c = torch.meshgrid(torch.arange(out, dtype=torch.float64, device=dev),
                          torch.arange(out, dtype=torch.float64, device=dev), indexing="ij")
    x = Ainv[0, 0] * c + Ainv[0, 1] * r + Ainv[0, 2]
    y = Ainv[1, 0] * c + Ainv[1, 1] * r + Ainv[1, 2]
    d = torch.as_tensor(diffs, device=dev)
    sc = torch.ones(T, dtype=torch.float64, device=dev) if scale is None else \
        torch.as_tensor(np.asarray(scale, np.float64), device=dev)
    x = (x[None] - d[:, 0, None, None]) * sc[:, None, None]
    y = (y[None] - d[:, 1, None, None]) * sc[:, None, None]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = rgb.reshape(T, H * W, 3)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(T, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, 3)).reshape(yi.shape + (3,))
        return torch.where(ok[..., None], v, 0.0)

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


def normalize(aligned: torch.Tensor) -> torch.Tensor:
    """[..., 3] 0..255 → ImageNet-normalised, same dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=aligned.dtype, device=aligned.device)
    std = torch.tensor(IMAGENET_STD, dtype=aligned.dtype, device=aligned.device)
    return (aligned - mean) / std
