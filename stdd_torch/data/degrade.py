"""The two pixel degradations of the I3D training augmentations, without cv2.

- :func:`jpeg_recompress` is the round trip that
  ``stdd_tpu/data/degrade.py:18`` makes with ``cv2.imencode('.jpg')`` and
  ``cv2.imdecode``: baseline JPEG as libjpeg writes and reads it by
  default. Encoder: the fixed-point RGB→YCbCr of ``jccolor.c``, 4:2:0
  chroma by ``jcsample.c``'s h2v2 box average (bias 1, 2, 1, 2, …), the
  ``islow`` integer DCT of ``jfdctint.c``, quantization at the IJG tables
  scaled by the quality (``jcparam.c``), rounding half away from zero.
  Decoder: dequantize, the ``islow`` inverse DCT of ``jidctint.c``,
  ``jdsample.c``'s h2v2 "fancy" triangle upsampling, the fixed-point
  YCbCr→RGB of ``jdcolor.c``. Huffman coding is lossless and is left out.
  Every step is libjpeg's integer arithmetic, so the pixels are OpenCV's
  bit for bit.
- :func:`gaussian_blur` is ``cv2.GaussianBlur(img, (k, k), 0)`` for
  k ∈ {3, 5} on uint8 images: with σ = 0 and k ≤ 7 OpenCV takes its fixed
  binomial kernels ([1 2 1]/4, [1 4 6 4 1]/16), and on 8-bit data its
  fixed-point path rounds the separable sum half up; borders are
  ``BORDER_REFLECT_101``. The result is bit-equal to OpenCV's. (The σ of
  ``0.3·((k−1)/2−1)+0.8`` is what OpenCV uses only for kernels outside
  that table; its Gaussian weights differ from the binomial ones by up to
  5 grey levels.)

Images are ``[..., H, W, 3]`` uint8 in OpenCV's BGR order, as the JAX
package hands them to cv2; leading axes (a clip's frames) are processed at
once.
"""

from __future__ import annotations

import numpy as np

_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
_CHROMA = np.full((8, 8), 99, np.int64)
_CHROMA[:4, :4] = np.array([
    17, 18, 24, 47,
    18, 21, 26, 66,
    24, 26, 56, 99,
    47, 66, 99, 99], np.int64).reshape(4, 4)

# fixed point of jccolor.c / jdcolor.c: SCALEBITS 16
_ONE_HALF = 1 << 15
_CBCR_OFFSET = 128 << 16


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


# jfdctint.c / jidctint.c ("islow"): 13-bit constants, 2 extra bits between
# the passes
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d, final: bool):
    """One pass of ``jpeg_fdct_islow`` over the first axis of [8, ...]."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    n = _CONST_BITS + _PASS1_BITS if final else _CONST_BITS - _PASS1_BITS
    if final:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, n)
    out[6] = _descale(z1 - tmp12 * _F1847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def _idct_pass(w, final: bool):
    """One pass of ``jpeg_idct_islow`` over the first axis of [8, ...]."""
    z2, z3 = w[2], w[6]
    z1 = (z2 + z3) * _F0541
    tmp2, tmp3 = z1 - z3 * _F1847, z1 + z2 * _F0765
    tmp0 = (w[0] + w[4]) << _CONST_BITS
    tmp1 = (w[0] - w[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = w[7], w[5], w[3], w[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * _F0298, tmp1 * _F2053, tmp2 * _F3072, tmp3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    n = _CONST_BITS + _PASS1_BITS + 3 if final else _CONST_BITS - _PASS1_BITS
    out = np.empty_like(w)
    out[0], out[7] = _descale(tmp10 + tmp3, n), _descale(tmp10 - tmp3, n)
    out[1], out[6] = _descale(tmp11 + tmp2, n), _descale(tmp11 - tmp2, n)
    out[2], out[5] = _descale(tmp12 + tmp1, n), _descale(tmp12 - tmp1, n)
    out[3], out[4] = _descale(tmp13 + tmp0, n), _descale(tmp13 - tmp0, n)
    return out


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling with baseline clamping (jcparam.c
    ``jpeg_quality_scaling`` + ``jpeg_add_quant_table``)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _pad_to(x: np.ndarray, mult: int) -> np.ndarray:
    """Replicate the last row and column up to a multiple of ``mult``."""
    h, w = x.shape[-2:]
    ph, pw = -h % mult, -w % mult
    pad = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(x, pad, mode="edge")


def _code_plane(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """[..., H, W] int samples (H, W multiples of 8) → the decoder's samples
    after the forward DCT, quantization (rounding half away from zero),
    dequantization and the inverse DCT."""
    *lead, h, w = plane.shape
    # [row, col, n, bx]: each pass runs over the leading axis, whose slices
    # are contiguous
    # int32 throughout: IJG sized CONST_BITS and PASS1_BITS so that every
    # intermediate of both DCTs fits 32 bits for 8-bit samples
    blocks = (plane.astype(np.int32) - 128).reshape(-1, 8, w // 8, 8).transpose(1, 3, 0, 2)
    coef = _fdct_pass(_fdct_pass(blocks.swapaxes(0, 1), False).swapaxes(0, 1), True)
    q = qt[:, :, None, None].astype(np.int32)                  # coef is [v, u, n, bx]
    div = q * 8                                                # the DCT output is scaled by 8
    quant = np.sign(coef) * ((np.abs(coef) + div // 2) // div)
    ws = _idct_pass(quant * q, False)                          # columns: over v → [y, u, ...]
    px = _idct_pass(ws.swapaxes(0, 1), True)                   # rows: over u → [x, y, ...]
    px = np.clip(px + 128, 0, 255)
    return px.transpose(2, 1, 3, 0).reshape(*lead, h, w)


def _upsample_h2v2_fancy(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """jdsample.c ``h2v2_fancy_upsample`` of a [..., ceil(h/2), ceil(w/2)]
    chroma plane, edges replicated as libjpeg's context rows and edge
    columns are, cropped to [..., h, w]. libjpeg takes the plain 2×2
    replication instead for planes at most 2 samples wide."""
    if c.shape[-1] <= 2:
        return c.repeat(2, axis=-2).repeat(2, axis=-1)[..., :h, :w]
    e = np.pad(c, [(0, 0)] * (c.ndim - 2) + [(1, 1), (1, 1)], mode="edge")
    mid = e[..., 1:-1, :]
    out = np.empty(c.shape[:-2] + (2 * c.shape[-2], 2 * c.shape[-1]), np.int32)
    for v, nb in ((0, e[..., :-2, :]), (1, e[..., 2:, :])):    # the row above, the row below
        col = 3 * mid + nb                                     # [..., rows, cols + 2]
        this, last, nxt = col[..., 1:-1], col[..., :-2], col[..., 2:]
        out[..., v::2, 0::2] = (3 * this + last + 8) >> 4
        out[..., v::2, 1::2] = (3 * this + nxt + 7) >> 4
    return out[..., :h, :w]


def jpeg_recompress(img: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY,
    quality]))`` for ``[..., H, W, 3]`` uint8 BGR images."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim < 3 or img.shape[-1] != 3:
        raise ValueError(f"jpeg_recompress wants [..., H, W, 3] uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[-3:-1]
    # libjpeg's edge expansion: the input's columns to the chroma blocks'
    # span (jcsample.c expand_right_edge) and its rows to a whole row pair;
    # after downsampling each plane's rows to whole blocks by repeating its
    # last row (jcprepct.c expand_bottom_edge)
    x = np.moveaxis(img.astype(np.int32), -1, 0)               # [3, ..., H, W]
    x = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, h % 2), (0, -w % 16)], mode="edge")
    b, g, r = x
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + _ONE_HALF) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> 16
    bias = np.tile(np.array([1, 2], np.int32), cb.shape[-1] // 4)

    def down(c):                                               # jcsample.c h2v2_downsample
        s = c[..., 0::2, 0::2] + c[..., 0::2, 1::2] + c[..., 1::2, 0::2] + c[..., 1::2, 1::2]
        return (s + bias) >> 2

    ql, qc = _quant_table(_LUMA, quality), _quant_table(_CHROMA, quality)
    y = _code_plane(_pad_to(y, 8), ql)[..., :h, :w]
    ch, cw = -(-h // 2), -(-w // 2)
    cb = _upsample_h2v2_fancy(_code_plane(_pad_to(down(cb), 8), qc)[..., :ch, :cw], h, w) - 128
    cr = _upsample_h2v2_fancy(_code_plane(_pad_to(down(cr), 8), qc)[..., :ch, :cw], h, w) - 128
    r = y + ((_fix(1.402) * cr + _ONE_HALF) >> 16)
    g = y + ((-_fix(0.34414) * cb + _ONE_HALF - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.772) * cb + _ONE_HALF) >> 16)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


_BINOMIAL = {3: np.array([1, 2, 1], np.int32), 5: np.array([1, 4, 6, 4, 1], np.int32)}


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` for ``[..., H, W, C]`` uint8
    images, k ∈ {3, 5}."""
    if k not in _BINOMIAL:
        raise ValueError(f"gaussian_blur: kernel size {k} not in {sorted(_BINOMIAL)}")
    img = np.asarray(img)
    b, p = _BINOMIAL[k], k // 2
    h, w = img.shape[-3:-1]
    pad = [(0, 0)] * (img.ndim - 3) + [(p, p), (p, p), (0, 0)]
    x = np.pad(img.astype(np.int32), pad, mode="reflect")      # BORDER_REFLECT_101
    rows = sum(b[i] * x[..., :, i:i + w, :] for i in range(k))
    s = sum(b[j] * rows[..., j:j + h, :, :] for j in range(k))
    # the fixed-point sum carries 8 fractional bits; rounding is half up
    return ((s * (256 // int(b.sum()) ** 2) + 128) >> 8).astype(np.uint8)
