"""Edge and region operations of the largest-tile picker, in numpy.

``stdd_tpu/runtime/sources.py:131-137`` segments a call's screen with
``cv2.Canny(gray, 60, 160)``, ``cv2.dilate(edges, ones((3, 3)))`` and the
bounding rectangles of ``cv2.findContours(255 - edges, RETR_EXTERNAL)``.
These are the same operations without cv2, bit-equal to OpenCV 5.0
(``tests/test_torch_edges.py``):

- :func:`canny` — cv2's default Canny: 3×3 Sobel in int16 with a
  replicated border, the L1 magnitude, non-maximum suppression by cv2's
  fixed-point tangent test (``TG22``; strict on one side, ``>=`` on the
  other, as cv2 breaks ties), then hysteresis: a pixel above ``low`` that
  survives suppression is an edge when its 8-connected run of such pixels
  holds one above ``high``;
- :func:`dilate3x3` — the 3×3 maximum, pixels outside the image ignored
  (cv2's default border for dilation);
- :func:`external_bounding_rects` — ``cv2.boundingRect`` of each contour
  ``findContours(RETR_EXTERNAL)`` returns, in cv2's order. A contour here
  is the outer border of an 8-connected component of non-zero pixels whose
  surrounding 4-connected background is the one outside the image: cv2 pads
  the image with one zero pixel, so a component touching the frame keeps its
  frame pixels, and a component inside another's hole is not external. cv2
  lists the contours last-found first, so the component whose first pixel
  (top row, then left) comes last in raster order comes first.

:func:`label_runs` is the shared connected-component labelling: runs of
each row, joined across rows where they touch, merged by hooking and
pointer jumping.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)   # cv2's CANNY_SHIFT 15


def _runs(mask: np.ndarray):
    """Row runs of a boolean ``[H, W]`` mask in raster order: (row, start,
    end exclusive)."""
    d = np.diff(np.pad(mask, ((0, 0), (1, 1))).astype(np.int8), axis=1)
    rs, ss = np.nonzero(d == 1)
    _, es = np.nonzero(d == -1)
    return rs.astype(np.int64), ss.astype(np.int64), es.astype(np.int64)


def label_runs(mask: np.ndarray, eight: bool):
    """Connected components of a boolean ``[H, W]`` mask (8- or
    4-connected). → ``(rows, starts, ends, comp)``: the runs in raster
    order and each run's component, numbered 0.. in the raster order of
    the components' first pixels."""
    r, s, e = _runs(mask)
    n = len(r)
    if n == 0:
        return r, s, e, np.zeros(0, np.int64)
    k = 1 if eight else 0
    big = mask.shape[1] + 4
    start_key = r * big + s
    end_key = r * big + e
    # the runs of the next row that touch each run: one contiguous range
    lo = np.searchsorted(end_key, (r + 1) * big + s - k, side="right")
    hi = np.searchsorted(start_key, (r + 1) * big + e + k, side="left")
    cnt = np.maximum(hi - lo, 0)
    a = np.repeat(np.arange(n), cnt)
    b = np.repeat(lo, cnt) + (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt))
    parent = np.arange(n)
    while a.size:
        pa, pb = parent[a], parent[b]
        diff = pa != pb
        if not diff.any():
            break
        pa, pb = pa[diff], pb[diff]
        low = np.minimum(pa, pb)
        np.minimum.at(parent, pa, low)
        np.minimum.at(parent, pb, low)
        while True:                                   # pointer jumping to the roots
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
    # every root is its component's first run, so raster order of roots is
    # raster order of first pixels
    _, comp = np.unique(parent, return_inverse=True)
    return r, s, e, comp.astype(np.int64)


def _paint(shape, r, s, e) -> np.ndarray:
    """A boolean mask of the given runs."""
    H, W = shape
    acc = np.zeros(H * (W + 1) + 1, np.int32)
    np.add.at(acc, r * (W + 1) + s, 1)
    np.add.at(acc, r * (W + 1) + e, -1)
    return (np.cumsum(acc)[:-1].reshape(H, W + 1)[:, :W] > 0)


def sobel3x3(gray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.Sobel(gray, CV_16S, 1, 0)`` and ``(0, 1)`` with
    ``BORDER_REPLICATE`` (Canny's border)."""
    p = np.pad(gray.astype(np.int32), 1, mode="edge")
    sm_v = p[:-2] + 2 * p[1:-1] + p[2:]                 # [H, W+2] vertical smoothing
    dx = sm_v[:, 2:] - sm_v[:, :-2]
    sm_h = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]        # [H+2, W]
    dy = sm_h[2:] - sm_h[:-2]
    return dx.astype(np.int16), dy.astype(np.int16)


def canny(gray: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(gray, low, high)`` (aperture 3, L1 gradient) on a uint8
    ``[H, W]`` image → uint8 edges, 255 on an edge."""
    if gray.ndim != 2 or gray.dtype != np.uint8:
        raise ValueError("canny: expects a uint8 [H, W] image")
    if low > high:
        low, high = high, low
    lo_t, hi_t = int(np.floor(low)), int(np.floor(high))
    dx, dy = sobel3x3(gray)
    xs, ys = dx.astype(np.int64), dy.astype(np.int64)
    mag = np.abs(xs) + np.abs(ys)
    H, W = gray.shape
    m = np.pad(mag, 1)                                   # magnitudes outside the image read 0
    c = m[1:-1, 1:-1]
    left, right = m[1:-1, :-2], m[1:-1, 2:]
    up, down = m[:-2, 1:-1], m[2:, 1:-1]
    ax = np.abs(xs)
    ay = np.abs(ys) << 15
    tg22x = ax * TG22
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x
    vert = ~horiz & (ay > tg67x)
    diag = ~horiz & ~vert
    s = np.where((xs ^ ys) < 0, -1, 1)
    # the diagonal neighbours: up row at j - s, down row at j + s
    up_l, up_r = m[:-2, :-2], m[:-2, 2:]
    dn_l, dn_r = m[2:, :-2], m[2:, 2:]
    up_d = np.where(s < 0, up_r, up_l)
    dn_d = np.where(s < 0, dn_l, dn_r)
    keep = c > lo_t
    keep &= ((horiz & (c > left) & (c >= right))
             | (vert & (c > up) & (c >= down))
             | (diag & (c > up_d) & (c > dn_d)))
    strong = keep & (c > hi_t)
    r, st, en, comp = label_runs(keep, eight=True)
    if len(r) == 0:
        return np.zeros((H, W), np.uint8)
    # a run holds a strong pixel where the strong count rises inside it
    cs = np.concatenate([np.zeros((H, 1), np.int64), np.cumsum(strong, axis=1)], axis=1)
    run_strong = cs[r, en] > cs[r, st]
    comp_strong = np.zeros(comp.max() + 1, bool)
    comp_strong[comp[run_strong]] = True
    sel = comp_strong[comp]
    return _paint((H, W), r[sel], st[sel], en[sel]).astype(np.uint8) * 255


def dilate3x3(img: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, np.ones((3, 3), np.uint8))``: the 3×3 maximum,
    pixels outside the image ignored."""
    p = np.pad(img, 1, mode="edge")     # an edge copy never raises a 3×3 maximum
    rows = np.maximum(np.maximum(p[:-2], p[1:-1]), p[2:])
    return np.maximum(np.maximum(rows[:, :-2], rows[:, 1:-1]), rows[:, 2:])


def external_bounding_rects(img: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """``[cv2.boundingRect(c) for c in cv2.findContours(img, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)[0]]`` for a uint8 ``[H, W]`` image (non-zero is
    foreground): ``(x, y, w, h)`` in cv2's order."""
    fg = np.asarray(img) != 0
    H, W = fg.shape
    r, s, e, comp = label_runs(fg, eight=True)
    if len(r) == 0:
        return []
    # the background with cv2's one-pixel zero frame, 4-connected; the
    # frame's component is the one of the padded corner
    br, bs, be, bcomp = label_runs(np.pad(~fg, 1, constant_values=True), eight=False)
    n = comp.max() + 1
    first = np.full(n, len(r))
    np.minimum.at(first, comp, np.arange(len(r)))
    # the background pixel above each component's first pixel (padded
    # coordinates: row r, column s + 1) lies just outside its outer border
    qy, qx = r[first], s[first] + 1
    big = W + 6
    run = np.searchsorted(br * big + bs, qy * big + qx, side="right") - 1
    external = bcomp[run] == bcomp[0]
    x0 = np.full(n, W)
    x1 = np.full(n, -1)
    y0 = np.full(n, H)
    y1 = np.full(n, -1)
    np.minimum.at(x0, comp, s)
    np.maximum.at(x1, comp, e - 1)
    np.minimum.at(y0, comp, r)
    np.maximum.at(y1, comp, r)
    order = [i for i in range(n - 1, -1, -1) if external[i]]
    return [(int(x0[i]), int(y0[i]), int(x1[i] - x0[i] + 1), int(y1[i] - y0[i] + 1))
            for i in order]
