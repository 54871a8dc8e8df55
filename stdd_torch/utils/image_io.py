"""PNG read and write in numpy and ``zlib``, without cv2 or PIL.

The JAX package reads and writes images with ``cv2.imread`` and
``cv2.imwrite`` (``stdd_tpu/data/libreface_align.py:103,162``); the
port may not import cv2, and the card's machine has neither cv2 nor PIL.
This codec covers the PNGs those calls make and read: 8-bit grayscale,
RGB and RGBA, non-interlaced, with all five row filters (None, Sub, Up,
Average, Paeth; libpng picks them row by row). Palette, gray+alpha,
16-bit and interlaced files are refused by name. The pixels are cv2's both
ways (``tests/test_torch_image_io.py``): :func:`imread` returns what
``cv2.imread(path)`` returns (BGR; gray replicated, alpha dropped), and a
file :func:`imwrite` writes reads back in cv2 as the array it was given.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}                  # colour type → samples a pixel
_REFUSED = {3: "palette", 4: "gray+alpha"}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ValueError(f"{path}: PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo each row's filter: [h, stride] uint8. Sub, Up and None are
    numpy; Average and Paeth depend on the row's own decoded bytes and
    run byte by byte."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is {len(raw)} bytes, not {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = (line.reshape(-1, bpp).astype(np.int64).cumsum(axis=0) % 256).astype(
                np.uint8).reshape(-1)
        elif ft == 2:
            cur = line + prev
        elif ft in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ft == 3:
                    cur[x] = (cur[x] + ((a + up[x]) >> 1)) & 255
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(a, up[x], c)) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has filter type {ft}, not 0-4")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit PNG as stored: ``[H, W]`` gray, ``[H, W, 3]``
    RGB or ``[H, W, 4]`` RGBA, uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype in _REFUSED:
        raise ValueError(f"{path}: {_REFUSED[ctype]} PNGs (colour type {ctype}) are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not a valid one")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported; only 8-bit")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    c = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c, path)
    return px.reshape(h, w, c)[..., 0] if c == 1 else px.reshape(h, w, c)


def _filter_rows(img: np.ndarray, ft: int, bpp: int) -> np.ndarray:
    """Filter type ``ft`` applied to every row of [h, stride] uint8."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if ft == 0:
        pred = 0
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = b
    elif ft == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``[H, W]`` gray, ``[H, W, 3]`` RGB or ``[H, W, 4]`` RGBA uint8
    as a PNG, each row's filter picked as libpng picks it among all five:
    the one whose bytes, read as signed, have the smallest sum of
    magnitudes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3, 4)):
        raise ValueError(f"write_png wants [H, W], [H, W, 3] or [H, W, 4] uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c)
    cand = np.stack([_filter_rows(rows, ft, c) for ft in range(5)])
    cost = np.abs(cand.view(np.int8).astype(np.int64)).sum(axis=2)
    cost[0] = rows.astype(np.int64).sum(axis=1)            # libpng scores None unsigned
    pick = cost.argmin(axis=0)
    body = cand[pick, np.arange(h)]
    raw = np.concatenate([pick.astype(np.uint8)[:, None], body], axis=1).tobytes()
    ctype = {1: 0, 3: 2, 4: 6}[c]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a PNG: ``[H, W, 3]`` BGR uint8, a gray
    image replicated into the three channels, an alpha channel dropped.
    Raises ``FileNotFoundError`` for a missing file (cv2 returns None)."""
    px = read_png(path)
    if px.ndim == 2:
        return np.repeat(px[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` for a PNG: ``[H, W]`` gray, ``[H, W, 3]``
    BGR or ``[H, W, 4]`` BGRA uint8."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    write_png(path, img)
    return True
