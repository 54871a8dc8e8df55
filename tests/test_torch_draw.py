"""The port's drawing primitives (``stdd_torch/utils/draw.py``) against
OpenCV 5.0, the calls the JAX package's overlay and annotator make.

Boxes (thickness 2 and others, filled), circles (radius 2 at thickness 2,
radius 1 filled, the one-pixel circle), gray and absdiff are bit-equal to
cv2, at the image's edges and partly off-frame. Text: OpenCV 5.0 renders
the Hershey font ids with an anti-aliased outline font whose bitmaps the
port tabulates from cv2 (``stdd_torch/assets/glyphs.npz``, pinned here to a
fresh rendering), so ``text_size`` equals ``cv2.getTextSize`` and
``put_text`` equals ``cv2.putText`` bit for bit on every label form the
callers make, on random backgrounds and partly off-frame: a stricter check
than the box rule (every changed pixel inside the label's box, every pixel
outside it equal), which is asserted as well.
"""

import cv2
import numpy as np
import pytest

from stdd_torch.data import degrade
from stdd_torch.utils import draw

from torch_port_helpers import glyph_table


def label_forms(rng, n):
    out = ["id7 0.53 *", "meeting: FAKE", "meeting: REAL", "meeting: ...", "FPS: 12.30",
           "0.9132", "id 3  p=0.73", "id12", "id 0 *"]
    for _ in range(n):
        t, p = int(rng.randint(0, 300)), float(rng.rand())
        out += [f"id{t}", f"id{t} {p:.2f}", f"id{t} {p:.2f} *", f"FPS: {rng.rand() * 200:.2f}",
                f"{p:.4f}", f"id {t}", f"id {t}  p={p:.2f}"]
    return out


def test_glyph_table_is_cv2s():
    want = glyph_table()
    with np.load(draw.GLYPHS_PATH) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("thickness", [2, 1, 3, -1])
def test_rectangle_bit_equal_to_cv2(thickness):
    rng = np.random.RandomState(thickness + 10)
    for _ in range(60):
        H, W = rng.randint(12, 50), rng.randint(12, 50)
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        # ends on, at and beyond the edges, degenerate boxes included
        p1 = (int(rng.randint(-15, W + 15)), int(rng.randint(-15, H + 15)))
        p2 = (int(rng.randint(-15, W + 15)), int(rng.randint(-15, H + 15)))
        if rng.rand() < 0.15:
            p2 = (p1[0], p2[1])
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want, got = img.copy(), img.copy()
        cv2.rectangle(want, p1, p2, color, thickness)
        assert draw.rectangle(got, p1, p2, color, thickness) is got
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2} {H}x{W}")
    edge = np.zeros((20, 30), np.uint8)                       # one channel, the frame's edge
    want = edge.copy()
    cv2.rectangle(want, (0, 0), (29, 19), 200, thickness)
    np.testing.assert_array_equal(draw.rectangle(edge, (0, 0), (29, 19), 200, thickness), want)


@pytest.mark.parametrize("radius,thickness", [(2, 2), (1, -1), (2, 1), (0, 2), (1, 2), (6, -1),
                                              (4, 1)])
def test_circle_bit_equal_to_cv2(radius, thickness):
    rng = np.random.RandomState(radius * 10 + thickness + 50)
    for _ in range(80):
        H, W = rng.randint(6, 30), rng.randint(6, 30)
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        c = (int(rng.randint(-radius - 3, W + radius + 3)),
             int(rng.randint(-radius - 3, H + radius + 3)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        want, got = img.copy(), img.copy()
        cv2.circle(want, c, radius, color, thickness)
        np.testing.assert_array_equal(draw.circle(got, c, radius, color, thickness), want,
                                      err_msg=f"{c} {H}x{W}")


def test_circle_refuses_what_it_does_not_rebuild():
    with pytest.raises(NotImplementedError, match="sine table"):
        draw.circle(np.zeros((9, 9, 3), np.uint8), (4, 4), 3, (1, 2, 3), 2)


@pytest.mark.parametrize("style", draw.TEXT_STYLES, ids=lambda s: draw.style_key(*s))
def test_text_size_equals_cv2(style):
    rng = np.random.RandomState(1)
    for s in label_forms(rng, 40) + ["", " ", "~!@#$%^&*()_+{}|:<>?`-=[]\\;',./\"", "gjpqy"]:
        assert draw.text_size(s, *style) == cv2.getTextSize(s, *style), s


@pytest.mark.parametrize("style", draw.TEXT_STYLES, ids=lambda s: draw.style_key(*s))
def test_put_text_bit_equal_to_cv2_and_inside_its_box(style):
    rng = np.random.RandomState(2)
    font, scale, thick = style
    for s in label_forms(rng, 6):
        H, W = rng.randint(16, 50), rng.randint(40, 140)
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        org = (int(rng.randint(-25, W - 5)), int(rng.randint(-3, H + 8)))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want, got = img.copy(), img.copy()
        cv2.putText(want, s, org, font, scale, color, thick)
        draw.put_text(got, s, org, font, scale, color, thick)
        np.testing.assert_array_equal(got, want, err_msg=f"{s!r} at {org}")
        (w, h), base = draw.text_size(s, font, scale, thick)
        box = np.zeros((H, W), bool)
        box[max(0, org[1] - h):max(0, org[1] + base), max(0, org[0]):max(0, org[0] + w)] = True
        changed = (got != img).any(-1)
        assert not (changed & ~box).any(), s                 # the box rule, beside equality


def test_put_text_refuses_untabulated_styles_and_characters():
    img = np.zeros((20, 60, 3), np.uint8)
    with pytest.raises(ValueError, match="not tabulated"):
        draw.put_text(img, "x", (0, 15), draw.FONT_HERSHEY_SIMPLEX, 1.0, (1, 1, 1))
    with pytest.raises(ValueError, match="printable ASCII"):
        draw.text_size("é", draw.FONT_HERSHEY_SIMPLEX, 0.5, 1)


def test_gray_and_absdiff_bit_equal_to_cv2():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    b = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    g = draw.to_gray(a)
    np.testing.assert_array_equal(g, cv2.cvtColor(a, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(degrade.grayscale(a)[..., 1], g)      # the one shared copy
    np.testing.assert_array_equal(draw.absdiff(g, draw.to_gray(b)),
                                  cv2.absdiff(g, cv2.cvtColor(b, cv2.COLOR_BGR2GRAY)))
