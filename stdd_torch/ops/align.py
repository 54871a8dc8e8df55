"""Clip-stable similarity-transform face alignment, batched over clips.

Port of ``stdd_tpu/ops/align.py`` (reference ``FasterCropAlignXRay``,
``test_tools/faster_crop_align_xray.py:11``; MATLAB-cp2tform solver
``test_tools/warp_for_xray.py:224,337,496``). For a whole clip ONE
similarity is fit from the stacked per-frame 5-point landmarks against the
canonical template, and every frame is warped with it. Every tensor
function here takes any number of leading batch dimensions (clips). The
host side at the end (numpy, one clip: ``find_similarity_np``,
``warp_affine_u8``, ``align_clip_host``) serves the dataset writer's
``--aligned`` mode; its cv2 twins (``warp_perspective_u8``,
``perspective_transform``, ``resize_u8``) serve the degradations, the
regen dataset and the LibreFace alignment.

Singular fits: padded batch slots carry all-zero landmarks, whose fit has
``sc = ss = 0``. The 4×4 normal equations and both inverses are therefore
solved in closed form (``torch.linalg.inv``/``solve`` raise on a singular
matrix, and their error check forces a host sync on the card): a zero
determinant yields inf/NaN parameters, exactly as ``jnp.linalg.inv`` does,
and the scorer masks those slots (``runtime/classifier.py``).
"""

from __future__ import annotations

import math
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


def _bilinear_u8(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: str) -> np.ndarray:
    """Sample a uint8 ``[H, W, C]`` image at float32 source coordinates
    ``sx``, ``sy`` ([oh, ow]): bilinear in float32, rounded half to even.
    Taps outside the image read 0 (``"constant"``) or clamp to the edge
    (``"replicate"``)."""
    H, W = img.shape[:2]
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
    return np.clip(np.rint(top + (bot - top) * fy), 0, 255).astype(np.uint8)


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
    out = _bilinear_u8(img, sx, sy, border)
    return out[..., 0] if squeeze else out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the float64 2×3
    rotation by ``angle`` degrees (counter-clockwise, image y down) and
    scaling about ``center`` (taken in float32, as cv2's ``Point2f``),
    computed as cv2 computes it."""
    a = angle * (math.pi / 180)                      # cv2: angle *= CV_PI/180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))   # a Point2f
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)`` (``DECOMP_LU``): the 3×3
    float64 homography taking four float32 points ``src`` to ``dst``. The
    8×8 system is built as cv2 builds it (the products of two float32
    coordinates rounded to float32) and solved by cv2's Gaussian
    elimination with partial pivoting, in the same order of operations,
    so the matrix is cv2's bit for bit."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        a[i, 0] = a[i + 4, 3] = s[i, 0]
        a[i, 1] = a[i + 4, 4] = s[i, 1]
        a[i, 2] = a[i + 4, 5] = 1.0
        a[i, 6], a[i, 7] = -s[i, 0] * d[i, 0], -s[i, 1] * d[i, 0]
        a[i + 4, 6], a[i + 4, 7] = -s[i, 0] * d[i, 1], -s[i, 1] * d[i, 1]
        b[i], b[i + 4] = d[i, 0], d[i, 1]
    A, x = a.tolist(), b.tolist()                  # Python floats: IEEE double, one op at a time
    for i in range(8):
        k = max(range(i, 8), key=lambda j: abs(A[j][i]))    # the first of equal pivots
        if abs(A[k][i]) < np.finfo(np.float64).eps * 10:
            raise ValueError("perspective_transform: the four points are degenerate")
        if k != i:
            A[i], A[k] = A[k], A[i]
            x[i], x[k] = x[k], x[i]
        r = -1.0 / A[i][i]
        for j in range(i + 1, 8):
            alpha = A[j][i] * r
            for c in range(i + 1, 8):
                A[j][c] += alpha * A[i][c]
            x[j] += alpha * x[i]
    for i in range(7, -1, -1):
        acc = x[i]
        for c in range(i + 1, 8):
            acc -= A[i][c] * x[c]
        x[i] = acc / A[i][i]
    return np.array(x + [1.0]).reshape(3, 3)


def _invert3(m: np.ndarray) -> np.ndarray:
    """cv2's closed-form 3×3 inverse (``invert`` for n = 3, float64)."""
    (a, b, c), (d, e, f), (g, h, i) = np.asarray(m, np.float64).tolist()
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    if det == 0:
        raise ValueError("warp_perspective_u8: the homography is singular")
    r = 1.0 / det
    return np.array([[(e * i - f * h) * r, (c * h - b * i) * r, (b * f - c * e) * r],
                     [(f * g - d * i) * r, (a * i - c * g) * r, (c * d - a * f) * r],
                     [(d * h - e * g) * r, (b * g - a * h) * r, (a * e - b * d) * r]])


def warp_perspective_u8(img: np.ndarray, M: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.warpPerspective(img, M, (w, h), INTER_LINEAR,
    BORDER_CONSTANT)`` on a uint8 ``[H, W, C]`` image in numpy: ``M`` is the
    forward 3×3 map, inverted in float64 as cv2 inverts it; each output
    pixel maps through the inverse in float32, samples bilinearly in
    float32 and rounds half to even; taps outside the image read 0.
    Against OpenCV 5.0's float32 warp it is off by one grey level on fewer
    than 5e-4 of the values (where cv2's fused multiply-adds put a value on
    the other side of .5), and equal elsewhere
    (``tests/test_torch_libreface.py``)."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    m = _invert3(M).astype(np.float32).reshape(9)
    xs = np.arange(ow, dtype=np.float32)[None, :]
    ys = np.arange(oh, dtype=np.float32)[:, None]
    w = m[6] * xs + (m[7] * ys + m[8])
    sx = (m[0] * xs + (m[1] * ys + m[2])) / w
    sy = (m[3] * xs + (m[4] * ys + m[5])) / w
    out = _bilinear_u8(img, sx, sy, "constant")
    return out[..., 0] if squeeze else out


# cv2's fixed point for uint8 INTER_LINEAR (INTER_RESIZE_COEF_BITS)
_RESIZE_BITS = 11


def _linear_taps(n_src: int, n_dst: int, pin: bool):
    """cv2's INTER_LINEAR taps along one axis: the two source indices and
    their 11-bit weights. The coordinate is computed in float64, rounded
    to float32, split into floor and fraction in float32; each weight is
    the fraction scaled by 2^11 and rounded half to even. Along x
    (``pin``) cv2 pins a tap left of 0 or right of the last column to that
    column with weight (1, 0); along y the rows are only clamped."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if pin:
        out = (s < 0) | (s >= n_src - 1)
        f[out] = 0
        s = np.clip(s, 0, n_src - 1)
    one = np.float32(1 << _RESIZE_BITS)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int32)
    w1 = np.rint(f * one).astype(np.int32)
    return np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1


def _area_taps(n_src: int, n_dst: int, scale: float):
    """cv2's ``computeResizeAreaTab`` along one axis, as [taps, n_dst]
    source indices and float32 weights in cv2's order (a zero weight pads
    an output with fewer taps)."""
    taps = [[] for _ in range(n_dst)]
    for dx in range(n_dst):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(int(np.floor(f2)), n_src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            taps[dx].append((s1 - 1, (s1 - f1) / cell))
        taps[dx] += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps[dx].append((s2, min(min(f2 - s2, 1.0), cell) / cell))
    n = max(len(t) for t in taps)
    idx = np.zeros((n, n_dst), np.int64)
    wt = np.zeros((n, n_dst), np.float32)
    for dx, t in enumerate(taps):
        for j, (s, a) in enumerate(t):
            idx[j, dx], wt[j, dx] = s, a
    return idx, wt


def resize_u8(img: np.ndarray, out_hw, interpolation: str = "linear") -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR | INTER_AREA)``
    of a uint8 ``[H, W]`` or ``[H, W, C]`` image in numpy, bit-equal to
    OpenCV 5.0 (``tests/test_torch_degrade.py``).

    - ``"linear"``: 11-bit weights (:func:`_linear_taps`), an exact integer
      sum along x, then along y cv2's vector arithmetic: each row sum
      shifted right by 4, multiplied by its weight and shifted right by 16,
      the two added, then rounded by ``(v + 2) >> 2``.
    - ``"area"``, a downscale: cv2's float32 area tables, the taps summed
      in cv2's order in float32 along x, then along y, and rounded half
      to even. An integer factor is cv2's fast path: a 2× box average
      rounds ``(sum + 2) >> 2``, other factors ``sum · (1/n)`` in float32.

    An exact 2× downscale is the area fast path in both modes, as cv2
    takes it."""
    if interpolation not in ("linear", "area"):
        raise ValueError(f"resize_u8: interpolation {interpolation!r} is not 'linear' or 'area'")
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_u8 wants uint8, got {img.dtype}")
    H, W = img.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(f"resize_u8: output size {ow}x{oh} is empty")
    sx, sy = 1.0 / (ow / W), 1.0 / (oh / H)
    ix, iy = int(np.rint(sx)), int(np.rint(sy))
    fast = abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps
    if interpolation == "linear" and fast and ix == iy == 2:
        interpolation = "area"
    lead = (slice(None),) + (None,) * (img.ndim - 1)       # broadcast a per-row weight
    col = (None, slice(None)) + (None,) * (img.ndim - 2)    # ... and a per-column one
    if interpolation == "area":
        if sx < 1 or sy < 1:
            raise ValueError(f"resize_u8: INTER_AREA upscales ({W}x{H} -> {ow}x{oh}) are not "
                             "ported; only downscales")
        if fast:
            s = img[:iy * oh, :ix * ow].astype(np.int32).reshape(
                (oh, iy, ow, ix) + img.shape[2:]).sum(axis=(1, 3))
            if ix == iy == 2:
                return ((s + 2) >> 2).astype(np.uint8)
            return np.clip(np.rint(s.astype(np.float32) * np.float32(1.0 / (ix * iy))),
                           0, 255).astype(np.uint8)
        xi, xw = _area_taps(W, ow, sx)
        yi, yw = _area_taps(H, oh, sy)
        src = img.astype(np.float32)
        buf = np.zeros((H, ow) + img.shape[2:], np.float32)
        for j in range(len(xi)):
            buf = buf + src[:, xi[j]] * xw[j][col]
        acc = buf[yi[0]] * yw[0][lead]
        for j in range(1, len(yi)):
            acc = acc + buf[yi[j]] * yw[j][lead]
        return np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(W, ow, pin=True)
    y0, y1, b0, b1 = _linear_taps(H, oh, pin=False)
    src = img.astype(np.int32)
    rows = src[:, x0] * a0[col] + src[:, x1] * a1[col]
    v = (((rows[y0] >> 4) * b0[lead]) >> 16) + (((rows[y1] >> 4) * b1[lead]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


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
