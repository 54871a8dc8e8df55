"""Clip-stable similarity-transform face alignment, batched over clips.

Port of ``stdd_tpu/ops/align.py`` (reference ``FasterCropAlignXRay``,
``test_tools/faster_crop_align_xray.py:11``; MATLAB-cp2tform solver
``test_tools/warp_for_xray.py:224,337,496``). For a whole clip ONE
similarity is fit from the stacked per-frame 5-point landmarks against the
canonical template, and every frame is warped with it. Every tensor
function here takes any number of leading batch dimensions (clips). The
host side at the end (numpy, one clip: ``find_similarity_np``,
``warp_affine_u8``, ``align_clip_host``) serves the dataset writer's
``--aligned`` mode.

Singular fits: padded batch slots carry all-zero landmarks, whose fit has
``sc = ss = 0``. The 4×4 normal equations and both inverses are therefore
solved in closed form (``torch.linalg.inv``/``solve`` raise on a singular
matrix, and their error check forces a host sync on the card): a zero
determinant yields inf/NaN parameters, exactly as ``jnp.linalg.inv`` does,
and the scorer masks those slots (``runtime/classifier.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# Canonical 5-point template (eyes, nose, mouth corners) for a 256px crop:
# std_points_317 + 30px padding, shifted (−30, −60) — warp_for_xray.py:547-564.
STD_POINTS_256 = np.array(
    [
        [85.82991, 115.7792],
        [169.0532, 114.3381],
        [127.574, 167.0006],
        [90.6964, 204.7014],
        [167.3069, 203.3733],
    ]
) + np.array([[0.0, -30.0]])


def std_points(size: int = 224, device="cuda") -> torch.Tensor:
    """Template scaled to the output crop size (FasterCropAlignXRay.__init__)."""
    return torch.as_tensor(STD_POINTS_256 * (size / 256.0), dtype=torch.float32,
                           device=device)


def _solve_nonreflective(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity mapping ``src → dst`` (warp_for_xray.py:224).

    ``src``, ``dst``: [..., M, 2]. The unknowns ``r = [sc, ss, tx, ty]``
    parameterize the INVERSE map (dst → src, ``u = sc·x + ss·y + tx``,
    ``v = sc·y − ss·x + ty``), as the reference does; the normal equations
    of that 4-unknown system are solved in closed form on centred points.
    Returns the 3x3 row-vector-convention matrix T with [u v 1] @ T = [x y 1]
    ([..., 3, 3]); non-finite when the fit is singular."""
    src = src.float()
    dst = dst.float()
    x, y = dst[..., 0], dst[..., 1]
    u, v = src[..., 0], src[..., 1]
    xm, ym = x.mean(-1, keepdim=True), y.mean(-1, keepdim=True)
    um, vm = u.mean(-1, keepdim=True), v.mean(-1, keepdim=True)
    xc, yc, uc, vc = x - xm, y - ym, u - um, v - vm
    den = (xc * xc + yc * yc).sum(-1)
    sc = (uc * xc + vc * yc).sum(-1) / den
    ss = (uc * yc - vc * xc).sum(-1) / den
    xm, ym, um, vm = xm[..., 0], ym[..., 0], um[..., 0], vm[..., 0]
    tx = um - sc * xm - ss * ym
    ty = vm - sc * ym + ss * xm
    # T = inv([[sc, -ss, 0], [ss, sc, 0], [tx, ty, 1]]): the 2x2 block of a
    # similarity inverts through its determinant sc² + ss²
    det = sc * sc + ss * ss
    a, b = sc / det, ss / det              # inv block: [[a, b], [-b, a]]
    e = -(tx * a - ty * b)
    f = -(tx * b + ty * a)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([a, b, zero], -1),
        torch.stack([-b, a, zero], -1),
        torch.stack([e, f, one], -1),
    ], -2)


def _tformfwd(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[..., :2, :2] + T[..., 2:3, :2]


def find_similarity(src: torch.Tensor, dst: torch.Tensor,
                    reflective: bool = True) -> torch.Tensor:
    """3x3 similarity (row-vector convention) mapping src→dst, [..., 3, 3].

    ``reflective=True`` replicates the reference's findSimilarity selection
    INCLUDING its aliasing quirk: both candidates are scored against the
    x-negated target (warp_for_xray.py:404-421)."""
    T1 = _solve_nonreflective(src, dst)
    if not reflective:
        return T1
    flip = torch.tensor([-1.0, 1.0], dtype=torch.float32, device=dst.device)
    dst_neg = dst.float() * flip
    T2r = _solve_nonreflective(src, dst_neg)
    refl = torch.diag(torch.tensor([-1.0, 1.0, 1.0], device=dst.device))
    T2 = T2r @ refl
    n1 = torch.linalg.vector_norm(_tformfwd(T1, src.float()) - dst_neg, dim=(-2, -1))
    n2 = torch.linalg.vector_norm(_tformfwd(T2, src.float()) - dst_neg, dim=(-2, -1))
    return torch.where((n1 <= n2)[..., None, None], T1, T2)


def similarity_cv2(src: torch.Tensor, dst: torch.Tensor, reflective: bool = True):
    """(2x3 cv2.warpAffine-convention matrix, 3x3 row-vector matrix) mapping
    src→dst (warp_for_xray.py:496 get_similarity_transform_for_cv2)."""
    T = find_similarity(src, dst, reflective)
    return T[..., :, :2].transpose(-1, -2), T


def invert_affine_2x3(M: torch.Tensor) -> torch.Tensor:
    """Invert [..., 2, 3] column-vector-convention affines in closed form
    (a singular one gives inf/NaN, never an exception)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    return torch.stack([
        torch.stack([ia, ib, -(ia * c + ib * f)], -1),
        torch.stack([id_, ie, -(id_ * c + ie * f)], -1),
    ], -2)


def bilinear_sample(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` [N, H, W, C] at ``(cx, cy)`` [N, S1, S2]
    → [N, S1, S2, C] float32; taps outside the image weigh 0 (cv2
    BORDER_CONSTANT 0) and a non-finite coordinate samples nothing (0).

    The arithmetic order — ``((v00·(1−wx))·(1−wy) + v01·wx·(1−wy)) + …`` —
    is the one ``csrc/warp_affine.cu`` reproduces operation for operation."""
    N, H, W, C = img.shape
    finite = torch.isfinite(cx) & torch.isfinite(cy)
    cx = torch.where(finite, cx, -2.0)
    cy = torch.where(finite, cy, -2.0)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    wx = (cx - x0)[..., None]
    wy = (cy - y0)[..., None]
    # clamp before the integer cast: huge finite coordinates stay out of image
    x0i = x0.clamp(-2, W).long()
    y0i = y0.clamp(-2, H).long()
    flat = img.float().reshape(N, H * W, C)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(yi.shape + (C,))
        return torch.where(valid[..., None], v, 0.0)

    return (
        tap(y0i, x0i) * (1 - wx) * (1 - wy)
        + tap(y0i, x0i + 1) * wx * (1 - wy)
        + tap(y0i + 1, x0i) * (1 - wx) * wy
        + tap(y0i + 1, x0i + 1) * wx * wy
    )


def warp_clip_bilinear(
    crops: torch.Tensor,      # [..., T, Hc, Wc, C] zero-padded per-frame crops
    tfm: torch.Tensor,        # [..., 2, 3] forward affine (canvas → output), cv2 convention
    diffs: torch.Tensor,      # [..., T, 2] (x, y) paste offsets of each crop in the canvas
    out_size: int,
    out_dtype=torch.float32,
    scales: Optional[torch.Tensor] = None,   # [..., T] per-frame crop scale factors
) -> torch.Tensor:
    """Fused paste-into-canvas + warpAffine for whole clips: each output
    pixel samples crop ``t`` at ``s_t (A^{-1}p − d_t)``, zero outside
    (reference process_single loop, faster_crop_align_xray.py:77-89). The
    coordinate arithmetic follows ``stdd_tpu.ops.align.warp_clip_bilinear``
    step for step."""
    *lead, T, H, W, C = crops.shape
    S = out_size
    dev = crops.device
    Minv = invert_affine_2x3(tfm.float())                      # [..., 2, 3]
    ys = torch.arange(S, dtype=torch.float32, device=dev)[:, None].expand(S, S)
    xs = torch.arange(S, dtype=torch.float32, device=dev)[None, :].expand(S, S)

    def coef(i, j):
        return Minv[..., i, j][..., None, None]

    src_x = coef(0, 0) * xs + coef(0, 1) * ys + coef(0, 2)      # [..., S, S]
    src_y = coef(1, 0) * xs + coef(1, 1) * ys + coef(1, 2)
    if scales is None:
        scales = torch.ones(tuple(lead) + (T,), dtype=torch.float32, device=dev)
    d = diffs.float()
    s = scales.float()[..., None, None]
    cx = (src_x[..., None, :, :] - d[..., 0, None, None]) * s  # [..., T, S, S]
    cy = (src_y[..., None, :, :] - d[..., 1, None, None]) * s
    out = bilinear_sample(crops.reshape(-1, H, W, C), cx.reshape(-1, S, S),
                          cy.reshape(-1, S, S))
    out = out.reshape(tuple(lead) + (T, S, S, C))
    if out_dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.to(out_dtype)


def transform_landmarks(lmks: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply the 3x3 row-vector transform [..., 3, 3] to [..., K, 2]
    landmarks (warp_for_xray.py:571); extra landmark dims broadcast."""
    while T.dim() < lmks.dim():
        T = T.unsqueeze(-3)
    return lmks @ T[..., :2, :2] + T[..., 2:3, :2]


def clip_geometry(big_boxes: torch.Tensor, lm5: torch.Tensor):
    """Per-clip canvas geometry: ``big_boxes`` [..., T, 4], ``lm5``
    [..., T, 5, 2] crop-local → (diffs [..., T, 2] crop offsets in the union
    canvas, pts [..., T, 5, 2] landmarks in canvas coordinates)."""
    left_top = big_boxes[..., :2].amin(dim=-2, keepdim=True)
    diffs = big_boxes[..., :2] - left_top
    return diffs, lm5 + diffs[..., None, :]


def align_clip(
    crops: torch.Tensor,        # [..., T, Hc, Wc, C] per-frame big-box crops (zero-padded)
    big_boxes: torch.Tensor,    # [..., T, 4] absolute (x1, y1, x2, y2) of each crop
    lm5: torch.Tensor,          # [..., T, 5, 2] landmarks in crop-local coords
    out_size: int = 224,
    lm68: Optional[torch.Tensor] = None,    # [..., T, 68, 2] optional, crop-local
    template: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,  # [..., T] per-frame crop scale factors
):
    """FasterCropAlignXRay.__call__ for whole clips. With ``scales``, crops
    are stored pre-scaled per frame while ``big_boxes``/``lm5`` stay in
    unscaled coordinates. Returns ``(aligned [..., T, S, S, C] float32,
    lm5_t, lm68_t or None, tfm [..., 2, 3])``."""
    T = crops.shape[-4]
    tpl = template if template is not None else std_points(out_size, crops.device)
    diffs, pts = clip_geometry(big_boxes.float(), lm5.float())
    tgt = tpl.repeat(T, 1)                                     # [T*5, 2]
    tfm, trans = similarity_cv2(pts.flatten(-3, -2), tgt)
    aligned = warp_clip_bilinear(crops, tfm, diffs, out_size, scales=scales)
    lm5_t = transform_landmarks(pts, trans)
    lm68_t = None
    if lm68 is not None:
        lm68_t = transform_landmarks(lm68.float() + diffs[..., None, :], trans)
    return aligned, lm5_t, lm68_t, tfm


# -- host side (numpy): the dataset writer's clip alignment ---------------------

def _solve_nonreflective_np(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`_solve_nonreflective` for one fit, for callers
    that stay on the host (the preprocess writer aligns thousands of
    clips)."""
    src = src.astype(np.float32)
    dst = dst.astype(np.float32)
    m = src.shape[0]
    x, y = dst[:, 0:1], dst[:, 1:2]
    ones = np.ones((m, 1), np.float32)
    zeros = np.zeros((m, 1), np.float32)
    X = np.concatenate(
        [np.concatenate([x, y, ones, zeros], axis=1),
         np.concatenate([y, -x, zeros, ones], axis=1)], axis=0)
    U = np.concatenate([src[:, 0:1], src[:, 1:2]], axis=0)
    sc, ss, tx, ty = np.linalg.solve(X.T @ X, X.T @ U).reshape(-1)
    Tinv = np.array([[sc, -ss, 0.0], [ss, sc, 0.0], [tx, ty, 1.0]], np.float32)
    T = np.linalg.inv(Tinv)
    T[:, 2] = [0.0, 0.0, 1.0]
    return T


def find_similarity_np(src: np.ndarray, dst: np.ndarray,
                       reflective: bool = True) -> np.ndarray:
    """Numpy twin of :func:`find_similarity` (same reference quirks)."""
    T1 = _solve_nonreflective_np(src, dst)

    def fwd(T, pts):
        p = np.concatenate([pts, np.ones((pts.shape[0], 1), pts.dtype)], axis=1)
        return (p @ T)[:, :2]

    if not reflective:
        return T1
    dst_neg = dst * np.array([-1.0, 1.0], dst.dtype)
    T2r = _solve_nonreflective_np(src, dst_neg)
    refl = np.array([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], np.float32)
    T2 = T2r @ refl
    norm1 = np.linalg.norm(fwd(T1, src) - dst_neg)
    norm2 = np.linalg.norm(fwd(T2, src) - dst_neg)
    return T1 if norm1 <= norm2 else T2


def warp_affine_u8(img: np.ndarray, M: np.ndarray, out_hw, border: str = "constant") -> np.ndarray:
    """``cv2.warpAffine(img, M, (w, h), INTER_LINEAR)`` on a uint8
    ``[H, W, C]`` image in numpy: ``M`` is the forward 2×3 map, inverted
    in float64 as cv2 inverts it; each output pixel samples the source at
    the inverse map in float32, interpolates bilinearly in float32 and
    rounds half to even. ``border`` is ``"constant"`` (taps outside the
    image read 0, ``BORDER_CONSTANT``) or ``"replicate"`` (taps clamp to the
    edge, ``BORDER_REPLICATE``). Against OpenCV 5.0's float32 warp it is
    off by one grey level on fewer than 1 value in 10^4, and equal
    elsewhere (``tests/test_torch_align.py``)."""
    if border not in ("constant", "replicate"):
        raise ValueError(f"warp_affine_u8: border {border!r} is not 'constant' or 'replicate'")
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    m = np.asarray(M, np.float64).reshape(6)
    det = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / det if det != 0 else 0.0
    a, b, c, e = m[4] * d, -m[1] * d, -m[3] * d, m[0] * d
    inv = np.array([a, b, -a * m[2] - b * m[5], c, e, -c * m[2] - e * m[5]], np.float32)
    xs = np.arange(ow, dtype=np.float32)[None, :]
    ys = np.arange(oh, dtype=np.float32)[:, None]
    sx = inv[0] * xs + (inv[1] * ys + inv[2])
    sy = inv[3] * xs + (inv[4] * ys + inv[5])
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0 = np.clip(x0, -2, W + 1).astype(np.int64)
    y0 = np.clip(y0, -2, H + 1).astype(np.int64)
    src = img.astype(np.float32)

    def tap(yy, xx):
        v = src[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        if border == "replicate":
            return v
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = p00 + (p01 - p00) * fx
    bot = p10 + (p11 - p10) * fx
    out = np.clip(np.rint(top + (bot - top) * fy), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def align_clip_host(
    crops,                      # sequence of [h_i, w_i, 3] uint8 big-box crops
    big_boxes: np.ndarray,      # [T, 4] absolute (x1, y1, x2, y2)
    lm5_local: np.ndarray,      # [T, 5, 2] landmarks in crop-local coords
    out_size: int = 224,
) -> np.ndarray:
    """FasterCropAlignXRay semantics on the host, for the dataset writer's
    ``--aligned`` mode: ONE similarity is fit from the clip's stacked 5-pt
    landmarks against the canonical template, and every frame is warped
    from the union canvas with it (:func:`warp_affine_u8`). Returns
    ``[T, out_size, out_size, 3] uint8``."""
    T = len(crops)
    bb = np.asarray(big_boxes, np.float32)
    left_top = bb[:, :2].min(axis=0)
    right_bot = bb[:, 2:].max(axis=0)
    W = int(np.ceil(right_bot[0] - left_top[0]))
    H = int(np.ceil(right_bot[1] - left_top[1]))
    diffs = bb[:, :2] - left_top[None, :]
    pts = np.concatenate(
        [np.asarray(lm5_local[i], np.float32) + diffs[i][None, :] for i in range(T)], axis=0)
    tpl = np.tile(np.asarray(STD_POINTS_256 * (out_size / 256.0), np.float32), (T, 1))
    M = find_similarity_np(pts, tpl)[:, :2].T   # 2x3, cv2's convention
    out = np.empty((T, out_size, out_size, 3), np.uint8)
    for i, c in enumerate(crops):
        canvas = np.zeros((H, W, 3), np.uint8)
        dx = int(round(float(diffs[i][0])))
        dy = int(round(float(diffs[i][1])))
        h = min(c.shape[0], H - dy)
        w = min(c.shape[1], W - dx)
        canvas[dy:dy + h, dx:dx + w] = c[:h, :w]
        out[i] = warp_affine_u8(canvas, M, (out_size, out_size))
    return out
