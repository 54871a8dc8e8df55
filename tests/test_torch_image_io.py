"""The port's PNG codec against cv2's (``stdd_torch/utils/image_io.py`` vs
``cv2.imread``/``cv2.imwrite``, libpng underneath).

Tolerance: none. A PNG cv2 writes, with each of the five row filters or
libpng's per-row choice, reads as cv2 reads it (gray, BGR, BGRA; through
``imread``: BGR with gray replicated and alpha dropped), and a PNG the port
writes (its rows filtered as libpng chooses) reads in cv2 as the array
written. Palette, gray+alpha, 16-bit and
interlaced files and a failed CRC are refused by name.
"""

import re
import struct
import zlib

import cv2
import numpy as np
import pytest

from stdd_torch.utils import image_io


def _image(channels, seed=0, hw=(45, 67)):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    smooth = (np.sin(xx / 6.0) + np.cos(yy / 4.0)) * 60 + 128
    rng = np.random.RandomState(seed)
    planes = [smooth, smooth[::-1], rng.randint(0, 256, hw), smooth[:, ::-1] * 0.5 + xx]
    img = np.stack(planes[:channels or 1], -1).clip(0, 255).astype(np.uint8)
    img[hw[0] // 3:hw[0] // 2] = 77                       # a flat band: Up and Sub rows
    return img[..., 0] if channels is None else img


def _filters_used(path):
    data = open(path, "rb").read()
    kinds = dict(image_io._chunks(data, path))
    w, h, _, ctype, _, _, _ = struct.unpack(">IIBBBBB", kinds[b"IHDR"])
    c = {0: 1, 2: 3, 6: 4}[ctype]
    raw = zlib.decompress(b"".join(b for k, b in image_io._chunks(data, path) if k == b"IDAT"))
    return set(np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)[:, 0].tolist())


CV2_FILTERS = {"default": ([], {1}), "none": ([cv2.IMWRITE_PNG_FILTER_NONE], {0}),
               "sub": ([cv2.IMWRITE_PNG_FILTER_SUB], {1}),
               "up": ([cv2.IMWRITE_PNG_FILTER_UP], {2}),
               "average": ([cv2.IMWRITE_PNG_FILTER_AVG], {3}),
               "paeth": ([cv2.IMWRITE_PNG_FILTER_PAETH], {4}),
               "adaptive": ([cv2.IMWRITE_PNG_ALL_FILTERS], None)}


@pytest.mark.parametrize("filters", list(CV2_FILTERS))
@pytest.mark.parametrize("channels", [None, 3, 4], ids=["gray", "bgr", "bgra"])
def test_cv2_written_png_reads_as_cv2_reads(tmp_path, channels, filters):
    """cv2's default writes every row with Sub; the filter flag selects
    one filter or libpng's per-row choice."""
    img = _image(channels)
    path = str(tmp_path / "cv.png")
    flag, used = CV2_FILTERS[filters]
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER] + flag if flag else [])
    assert _filters_used(path) == used if used else len(_filters_used(path)) >= 2
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    stored = image_io.read_png(path)
    unchanged = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels:
        unchanged = np.concatenate([unchanged[..., 2::-1], unchanged[..., 3:]], axis=2)
    np.testing.assert_array_equal(stored, unchanged)


@pytest.mark.parametrize("channels", [None, 3, 4], ids=["gray", "rgb", "rgba"])
def test_port_written_png_reads_back_in_cv2(tmp_path, channels):
    img = _image(channels, seed=1)
    path = str(tmp_path / "port.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels:
        back = np.concatenate([back[..., 2::-1], back[..., 3:]], axis=2)
    np.testing.assert_array_equal(back, img)
    assert len(_filters_used(path)) >= 3                  # rows filtered several ways


def test_imwrite_takes_bgr_as_cv2_does(tmp_path):
    img = _image(3, seed=2)
    image_io.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), img)
    np.testing.assert_array_equal(image_io.imread(str(tmp_path / "b.png")), img)


def _patched(path, out, **ihdr):
    """Copy a PNG with IHDR fields replaced (its CRC recomputed)."""
    data = bytearray(open(path, "rb").read())
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    fields = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    fields.update(ihdr)
    body = struct.pack(">IIBBBBB", *(fields[k] for k in names))
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    open(out, "wb").write(bytes(data))
    return out


def test_unsupported_files_are_refused_by_name(tmp_path):
    gray = str(tmp_path / "g.png")
    image_io.write_png(gray, _image(None))
    cases = {"palette": _patched(gray, str(tmp_path / "p.png"), ctype=3),
             "gray+alpha": _patched(gray, str(tmp_path / "ga.png"), ctype=4),
             "interlaced": _patched(gray, str(tmp_path / "i.png"), interlace=1)}
    deep = str(tmp_path / "d.png")
    cv2.imwrite(deep, (_image(None).astype(np.uint16) * 257))
    cases["16-bit"] = deep
    for word, path in cases.items():
        with pytest.raises(ValueError, match=re.escape(word)):
            image_io.read_png(path)
    data = bytearray(open(gray, "rb").read())
    data[-20] ^= 0xFF                                        # inside IDAT
    open(str(tmp_path / "crc.png"), "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(str(tmp_path / "crc.png"))
    (tmp_path / "x.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(str(tmp_path / "x.png"))
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
