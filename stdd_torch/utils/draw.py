"""Drawing primitives of the overlay and the annotator, in numpy.

The JAX package draws with cv2 (``runtime/app.py:113`` ``draw_overlay``,
``eval/viz.py``); the port may not import it, so the calls those modules
make are rebuilt here, held to OpenCV 5.0 (``tests/test_torch_draw.py``):

- :func:`rectangle` and :func:`circle` follow ``imgproc/src/drawing.cpp``
  with ``LINE_8``: coordinates at ``XY_SHIFT`` (16-bit) fixed point, a line
  thicker than one pixel filled as a convex quad (``FillConvexPoly`` with
  its ``Line2`` outline, both clipped as cv2 clips them) with round caps
  (the integer ``Circle``), a circle thicker than one pixel drawn as
  ``EllipseEx``'s polygon, a filled or one-pixel circle by ``Circle``.
  Bit-equal to cv2, partly off-frame too.
- :func:`put_text` and :func:`text_size` for the four label styles the
  callers use (``FONT_HERSHEY_SIMPLEX`` 0.5 with thickness 1 and 2, 0.7
  with 2, ``FONT_HERSHEY_DUPLEX`` 0.5 with 1). OpenCV 5.0 renders these
  "Hershey" faces with its built-in anti-aliased outline font, not the
  Hershey strokes: each character advances the pen by a whole number of
  pixels, and its coverage bitmap is blended over the image, character
  after character, as ``(bg·(255 − a) + colour·a + 127) // 255``. The
  bitmaps, advances and baselines are cv2's own, tabulated in
  ``stdd_torch/assets/glyphs.npz`` (written by
  ``tests/torch_port_helpers.py::write_glyph_table`` and pinned to cv2 by
  ``tests/test_torch_draw.py``). Printable ASCII only.
- :func:`to_gray` (``COLOR_BGR2GRAY``: OpenCV 5's 15-bit weights) and
  :func:`absdiff`.

Every drawing function draws in place on a ``uint8`` ``[H, W]`` or
``[H, W, C]`` image and returns it, as cv2's do.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

FONT_HERSHEY_SIMPLEX = 0
FONT_HERSHEY_DUPLEX = 2

GLYPHS_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets", "glyphs.npz")
# (font, scale, thickness) of every label the app and the annotator draw
TEXT_STYLES = ((FONT_HERSHEY_SIMPLEX, 0.5, 1), (FONT_HERSHEY_SIMPLEX, 0.5, 2),
               (FONT_HERSHEY_SIMPLEX, 0.7, 2), (FONT_HERSHEY_DUPLEX, 0.5, 1))


def style_key(font: int, scale: float, thickness: int) -> str:
    return f"f{int(font)}_s{int(round(scale * 100))}_t{int(thickness)}"


# -- gray and difference -------------------------------------------------------

def to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2GRAY)`` on uint8 BGR ``[..., 3]``:
    OpenCV 5's 15-bit fixed-point weights (9798, 19235, 3735), rounded."""
    x = img.astype(np.int32)
    g = (9798 * x[..., 2] + 19235 * x[..., 1] + 3735 * x[..., 0] + (1 << 14)) >> 15
    return g.astype(np.uint8)


def absdiff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``cv2.absdiff`` of two uint8 arrays."""
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.uint8)


# -- cv2's rasterizers ---------------------------------------------------------

def _color(img: np.ndarray, color) -> np.ndarray:
    c = np.atleast_1d(np.asarray(color, np.float64))
    n = 1 if img.ndim == 2 else img.shape[2]
    c = np.concatenate([c, np.zeros(max(0, n - c.size))])[:n]    # a Scalar's missing channels are 0
    # cv2's scalarToRawData: saturate_cast<uchar>, rounding half to even
    return np.clip(np.rint(c), 0, 255).astype(np.uint8)


def _hline(img, y: int, x1: int, x2: int, col) -> None:
    """Pixels x1..x2 of row y, clipped."""
    H, W = img.shape[:2]
    if 0 <= y < H:
        x1, x2 = max(x1, 0), min(x2, W - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = col


def _put(img, xs: np.ndarray, ys: np.ndarray, col) -> None:
    H, W = img.shape[:2]
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[keep], xs[keep]] = col


def _circle_int(img, cx: int, cy: int, radius: int, col, fill: bool) -> None:
    """cv2's integer ``Circle`` (drawing.cpp): the midpoint walk, rows as
    spans when filled, eight points a step otherwise; clipped pixel by
    pixel."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    pts = []
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if fill:
            for y, a, b in ((y11, x11, x12), (y12, x11, x12), (y21, x21, x22), (y22, x21, x22)):
                _hline(img, y, a, b, col)
        else:
            pts += [(x11, y11), (x11, y12), (x12, y11), (x12, y12),
                    (x21, y21), (x21, y22), (x22, y21), (x22, y22)]
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    if pts:
        p = np.asarray(pts, np.int64)
        _put(img, p[:, 0], p[:, 1], col)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """cv2's ``clipLine`` on a size in fixed point; → (ok, p1, p2)."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line2(img, p1, p2, col) -> None:
    """cv2's ``Line2``: an 8-connected line between fixed-point ends."""
    H, W = img.shape[:2]
    ok, (x1, y1), (x2, y2) = _clip_line(W << XY_SHIFT, H << XY_SHIFT, p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _trunc_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _trunc_div(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, np.array([(x2 + (XY_ONE >> 1)) >> XY_SHIFT]),
         np.array([(y2 + (XY_ONE >> 1)) >> XY_SHIFT]), col)
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        xs = (x1 + k * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    _put(img, xs, ys, col)


def _fill_convex_poly(img, v: Sequence[Tuple[int, int]], col) -> None:
    """cv2's ``FillConvexPoly`` for ``LINE_8`` at ``XY_SHIFT``: the outline
    by ``Line2``, then scanlines between the two edge walkers."""
    H, W = img.shape[:2]
    shift = XY_SHIFT
    delta = 1 << shift >> 1
    npts = len(v)
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(img, p0, p, col)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    edges = npts
    e_idx = [imin, imin]
    e_ye = [ymin, ymin]
    e_di = [1, npts - 1]
    e_x = [-XY_ONE, -XY_ONE]
    e_dx = [0, 0]
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0, di = e_idx[i], e_di[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e_ye[i] = ty
                        e_dx[i] = _trunc_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1          # the C loop's post-decrement on exit
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + delta) >> XY_SHIFT
            xx2 = (e_x[right] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < W:
                _hline(img, y, max(xx1, 0), min(xx2, W - 1), col)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _cv_round(x: float) -> int:
    """``cvRound``: to nearest, ties to even (the SSE2 conversion)."""
    return int(np.rint(x))


def _thick_line(img, p0, p1, col, thickness: int, flags: int) -> None:
    """cv2's ``ThickLine`` for ``LINE_8`` between fixed-point ends:
    thickness ≤ 1 → ``Line2``; else a quad and round caps at the ends
    ``flags`` names (bit 0 the start, bit 1 the end)."""
    if thickness <= 1:
        _line2(img, p0, p1, col)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _cv_round(dy * r), _cv_round(dx * r)
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)], col)
    for i in range(2):
        if flags & (i + 1):
            cx = (p0[0] + (XY_ONE >> 1)) >> XY_SHIFT
            cy = (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT
            _circle_int(img, cx, cy, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, col, True)
        p0 = p1


def _poly_line(img, v, closed: bool, col, thickness: int) -> None:
    """cv2's ``PolyLine``: caps at the far end of every segment, and at the
    start of an open line's first."""
    if not v:
        return
    i = len(v) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = v[i]
    for i in range(0 if closed else 1, len(v)):
        _thick_line(img, p0, v[i], col, thickness, flags)
        p0 = v[i]
        flags = 2


# -- public drawing calls --------------------------------------------------------

def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` with ``LINE_8``
    (a negative thickness fills)."""
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    col = _color(img, color)
    v = [(x1 << XY_SHIFT, y1 << XY_SHIFT), (x2 << XY_SHIFT, y1 << XY_SHIFT),
         (x2 << XY_SHIFT, y2 << XY_SHIFT), (x1 << XY_SHIFT, y2 << XY_SHIFT)]
    if thickness >= 0:
        _poly_line(img, v, True, col, thickness)
    else:
        _fill_convex_poly(img, v, col)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness)`` with ``LINE_8``:
    a filled (negative thickness) or one-pixel circle by ``Circle``, a
    thicker one as ``EllipseEx``'s polygon. ``EllipseEx`` steps 90° below a
    radius of 3 and through cv2's float sine table above; only the former
    is rebuilt here."""
    cx, cy, radius = int(center[0]), int(center[1]), int(radius)
    if radius < 0:
        raise ValueError("circle: radius must be ≥ 0")
    col = _color(img, color)
    if thickness <= 1:
        _circle_int(img, cx, cy, radius, col, thickness < 0)
        return img
    if radius >= 3:
        raise NotImplementedError(
            f"circle: a thickness of {thickness} at radius {radius} needs cv2's sine table "
            "(EllipseEx steps finer than 90° from radius 3); the callers draw radius 2")
    # ellipse2Poly at 90° steps: the four axis points, the first repeated
    c = (cx << XY_SHIFT, cy << XY_SHIFT)
    r = radius << XY_SHIFT
    v = [(c[0] + r, c[1]), (c[0], c[1] + r), (c[0] - r, c[1]), (c[0], c[1] - r), (c[0] + r, c[1])]
    pts = []
    for p in v:
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts = [c, c]
    _poly_line(img, pts, False, col, thickness)
    return img


# -- text ------------------------------------------------------------------------

class _Glyphs:
    """One style's table: per printable character its advance, the rows its
    ink reaches below the baseline, its coverage bitmap and where that
    bitmap lies from the pen (left, top); the style's height."""

    def __init__(self, tab: Dict[str, np.ndarray], key: str):
        self.adv = tab[f"{key}_adv"].astype(np.int64)
        self.base = tab[f"{key}_base"].astype(np.int64)
        self.box = tab[f"{key}_box"].astype(np.int64)          # [95, 4] dx, dy, h, w
        self.off = tab[f"{key}_off"].astype(np.int64)          # [96]
        self.cov = tab[f"{key}_cov"]
        self.height = int(tab[f"{key}_height"])

    def bitmap(self, i: int) -> np.ndarray:
        h, w = self.box[i, 2], self.box[i, 3]
        return self.cov[self.off[i]:self.off[i + 1]].reshape(h, w)


_TABLES: Dict[str, _Glyphs] = {}


def _glyphs(font: int, scale: float, thickness: int) -> _Glyphs:
    key = style_key(font, scale, thickness)
    if key not in _TABLES:
        if (font, scale, thickness) not in TEXT_STYLES:
            raise ValueError(f"text style (font {font}, scale {scale}, thickness {thickness}) "
                             f"is not tabulated; the tabulated ones are {TEXT_STYLES}")
        with np.load(GLYPHS_PATH) as tab:
            _TABLES[key] = _Glyphs(dict(tab), key)
    return _TABLES[key]


def _codes(text: str) -> np.ndarray:
    codes = np.array([ord(ch) - 32 for ch in text], np.int64)
    if ((codes < 0) | (codes > 94)).any():
        raise ValueError(f"text {text!r}: only printable ASCII is tabulated")
    return codes


def text_size(text: str, font: int, scale: float, thickness: int = 1
              ) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(text, font, scale, thickness)`` → ``((w, h),
    baseline)``: the advances summed plus one, the style's height, and the
    rows the lowest ink reaches below the baseline."""
    if not text:
        return (0, 0), 0
    g = _glyphs(font, scale, thickness)
    c = _codes(text)
    return (int(g.adv[c].sum()) + 1, g.height), int(g.base[c].max())


def put_text(img: np.ndarray, text: str, org, font: int, scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """``cv2.putText(img, text, org, font, scale, color, thickness)``: each
    character's coverage blended over the image in turn,
    ``(bg·(255 − a) + colour·a + 127) // 255``, clipped to the image."""
    if not text:
        return img
    g = _glyphs(font, scale, thickness)
    col = _color(img, color).astype(np.int64)
    H, W = img.shape[:2]
    pen = int(org[0])
    for i in _codes(text):
        dx, dy, h, w = (int(v) for v in g.box[i])
        x0, y0 = pen + dx, int(org[1]) + dy
        pen += int(g.adv[i])
        if h == 0 or x0 >= W or y0 >= H or x0 + w <= 0 or y0 + h <= 0:
            continue
        a = g.bitmap(i).astype(np.int64)
        ya, xa = max(0, -y0), max(0, -x0)
        yb, xb = min(h, H - y0), min(w, W - x0)
        a = a[ya:yb, xa:xb]
        region = img[y0 + ya:y0 + yb, x0 + xa:x0 + xb]
        if img.ndim == 3:
            a = a[..., None]
        bg = region.astype(np.int64)
        region[...] = ((bg * (255 - a) + col * a + 127) // 255).astype(np.uint8)
    return img
