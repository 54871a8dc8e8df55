"""The port's Canny, dilation and external contour rectangles
(``stdd_torch/ops/edges.py``) bit-equal to OpenCV 5.0's ``cv2.Canny``,
``cv2.dilate`` and ``cv2.boundingRect`` over ``cv2.findContours(...,
RETR_EXTERNAL)``, in cv2's order: natural and grid images, random and
binary pixels, nested holes, an equal-area tie and the frame's border."""

import cv2
import numpy as np
import pytest

from stdd_torch.ops import edges


def natural(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 70 * np.sin(xx / (5.0 + seed) + seed) * np.cos(yy / 7.0 - seed)
    return np.clip(base + rng.randn(h, w) * 6, 0, 255).astype(np.uint8)


def grid(h, w, seed):
    """A call grid: smooth tiles on a dark background, one tile larger."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 25, np.uint8)
    for y0, x0, y1, x1 in ((2, 2, h // 2 - 2, w // 2 - 2), (2, w // 2 + 2, h // 2 - 2, w - 2),
                           (h // 2 + 2, 2, h - 2, w - 2)):
        img[y0:y1, x0:x1] = natural(y1 - y0, x1 - x0, int(rng.randint(0, 9)))
    return img


def rects_cv2(img):
    cs, _ = cv2.findContours(img, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return [tuple(int(v) for v in cv2.boundingRect(c)) for c in cs]


IMAGES = {
    "natural": lambda: natural(48, 64, 1),
    "grid": lambda: grid(60, 80, 2),
    "random": lambda: np.random.RandomState(3).randint(0, 256, (23, 31)).astype(np.uint8),
    "binary": lambda: (np.random.RandomState(4).rand(30, 40) < 0.5).astype(np.uint8) * 220,
    "flat": lambda: np.full((9, 13), 77, np.uint8),
    "one_row": lambda: np.random.RandomState(5).randint(0, 256, (1, 17)).astype(np.uint8),
}


@pytest.mark.parametrize("name", list(IMAGES))
def test_canny_and_dilate_bit_equal_to_cv2(name):
    g = IMAGES[name]()
    for lo, hi in ((60, 160), (160, 60), (10.5, 30.9)):
        want = cv2.Canny(g, lo, hi)
        got = edges.canny(g, lo, hi)
        assert got.dtype == np.uint8 and np.array_equal(got, want), (lo, hi)
    e = edges.canny(g, 60, 160)
    np.testing.assert_array_equal(edges.dilate3x3(e), cv2.dilate(e, np.ones((3, 3), np.uint8)))
    np.testing.assert_array_equal(edges.dilate3x3(g), cv2.dilate(g, np.ones((3, 3), np.uint8)))


def test_canny_on_random_smooth_images():
    rng = np.random.RandomState(6)
    for _ in range(25):
        H, W = rng.randint(4, 40), rng.randint(4, 40)
        small = rng.randint(0, 256, (H // 3 + 2, W // 3 + 2)).astype(np.uint8)
        g = cv2.resize(small, (W, H), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(edges.canny(g, 60, 160), cv2.Canny(g, 60, 160))


@pytest.mark.parametrize("name", ["natural", "grid", "random", "binary"])
def test_external_rects_of_the_picker_input_equal_cv2(name):
    fg = 255 - edges.dilate3x3(edges.canny(IMAGES[name](), 60, 160))
    assert edges.external_bounding_rects(fg) == rects_cv2(fg)


def test_external_rects_nested_holes_tie_and_border():
    ring = np.zeros((40, 40), np.uint8)
    ring[5:35, 5:35] = 255
    ring[8:32, 8:32] = 0
    ring[12:28, 12:28] = 255          # inside the ring's hole: not external
    ring[15:25, 15:25] = 0
    ring[18:22, 18:22] = 255
    assert edges.external_bounding_rects(ring) == rects_cv2(ring) == [(5, 5, 30, 30)]
    # four equal squares: cv2 lists the last found (raster order of first
    # pixels) first, so the picker's first strictly largest is bottom-right
    tie = np.zeros((8, 10), np.uint8)
    for y, x in ((1, 1), (1, 6), (5, 1), (5, 6)):
        tie[y:y + 2, x:x + 2] = 255
    assert edges.external_bounding_rects(tie) == rects_cv2(tie) == [
        (6, 5, 2, 2), (1, 5, 2, 2), (6, 1, 2, 2), (1, 1, 2, 2)]
    # a foreground that touches the frame keeps its frame pixels (cv2 pads
    # the image with zeros; it does not clear the border)
    full = np.full((8, 10), 255, np.uint8)
    full[3:5, 3:6] = 0
    assert edges.external_bounding_rects(full) == rects_cv2(full) == [(0, 0, 10, 8)]
    assert edges.external_bounding_rects(np.zeros((5, 5), np.uint8)) == rects_cv2(
        np.zeros((5, 5), np.uint8)) == []


def test_external_rects_on_random_shapes():
    rng = np.random.RandomState(7)
    for _ in range(40):
        H, W = rng.randint(10, 60), rng.randint(10, 60)
        m = np.zeros((H, W), np.uint8)
        for _ in range(rng.randint(1, 10)):
            y0, x0 = rng.randint(0, H), rng.randint(0, W)
            h, w = rng.randint(2, H), rng.randint(2, W)
            v = int(rng.choice([0, 255]))
            if rng.rand() < 0.5:
                m[y0:y0 + h, x0:x0 + w] = v
            else:
                cv2.rectangle(m, (x0, y0), (x0 + w, y0 + h), v, int(rng.randint(1, 3)))
        assert edges.external_bounding_rects(m) == rects_cv2(m)
