"""YUV4MPEG2 (``.y4m``) video reader and writer, without cv2.

The JAX package reads video through ``cv2.VideoCapture``
(``stdd_tpu/data/preprocess.py``, ``stdd_tpu/utils/video_io.py``); the port
may not import cv2, so its video files are ``.y4m``: a text header, then
each frame as ``FRAME`` and planar I420 bytes (Y, then U and V at quarter
size). :func:`read_y4m` decodes 4:2:0 to BGR uint8 with the integer
arithmetic of ``cv2.cvtColor(COLOR_YUV2BGR_I420)`` (BT.601 video range, Q20,
nearest-neighbour chroma), so a frame is bit-equal to that conversion of the
same planes. :func:`write_y4m` encodes with the port's I420 encoder
(``runtime/packing.py::rgb_to_i420``, bit-equal to
``cv2.cvtColor(COLOR_RGB2YUV_I420)``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from ..runtime.packing import rgb_to_i420

MAGIC = b"YUV4MPEG2"
# cv2's YUV420 → RGB coefficients (BT.601 video range, Q20)
_CY, _CUB, _CUG, _CVG, _CVR = 1220542, 2116026, -409993, -852492, 1673527
_SHIFT = 20
# 4:2:0 chroma sitings; all decode alike (nearest-neighbour chroma)
_CHROMA_420 = ("420", "420jpeg", "420paldv", "420mpeg2")


def parse_header(line: bytes, path: str = "") -> Dict[str, str]:
    """``YUV4MPEG2 W.. H.. F.. I.. A.. C..`` → its tags. Raises a
    ``ValueError`` naming the tag for a stream this reader cannot decode:
    another magic, a missing size, an odd size, interlaced frames or a
    chroma format other than 4:2:0."""
    parts = line.rstrip(b"\n").split(b" ")
    if parts[0] != MAGIC:
        raise ValueError(f"{path}: not a YUV4MPEG2 stream (header {line[:32]!r})")
    tags = {p[:1].decode(): p[1:].decode() for p in parts[1:] if p}
    if "W" not in tags or "H" not in tags:
        raise ValueError(f"{path}: y4m header without W or H: {line!r}")
    w, h = int(tags["W"]), int(tags["H"])
    if w <= 0 or h <= 0 or w % 2 or h % 2:
        raise ValueError(f"{path}: y4m size {w}x{h} is not even; 4:2:0 needs even sides")
    interlace = tags.get("I", "p")
    if interlace not in ("p", "?"):
        raise ValueError(f"{path}: interlaced y4m (I{interlace}) is not supported; "
                         "only progressive frames (Ip)")
    chroma = tags.get("C", "420jpeg")
    if chroma not in _CHROMA_420:
        raise ValueError(f"{path}: y4m chroma format C{chroma} is not supported; only 4:2:0 "
                         f"({', '.join('C' + c for c in _CHROMA_420)})")
    return tags


def i420_to_bgr(planes: np.ndarray, h: int, w: int) -> np.ndarray:
    """Flat I420 bytes of one ``h × w`` frame → BGR uint8 ``[h, w, 3]``,
    bit-equal to ``cv2.cvtColor(COLOR_YUV2BGR_I420)``."""
    n = h * w
    q = n // 4
    y = planes[:n].reshape(h, w).astype(np.int32)
    u = planes[n:n + q].reshape(h // 2, w // 2).astype(np.int32) - 128
    v = planes[n + q:n + 2 * q].reshape(h // 2, w // 2).astype(np.int32) - 128
    half = 1 << (_SHIFT - 1)
    # each chroma term is added to its 2×2 block of luma by broadcasting
    yy = (np.maximum(y - 16, 0) * _CY).reshape(h // 2, 2, w // 2, 2)
    out = np.empty((h // 2, 2, w // 2, 2, 3), np.uint8)
    for c, uv in enumerate((half + _CUB * u, half + _CVG * v + _CUG * u, half + _CVR * v)):
        out[..., c] = np.clip((yy + uv[:, None, :, None]) >> _SHIFT, 0, 255)
    return out.reshape(h, w, 3)


def read_y4m(path: str, max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield the BGR uint8 frames of a ``.y4m`` file, at most
    ``max_frames``. A truncated last frame ends the stream, as a decoder's
    read would."""
    with open(path, "rb") as f:
        tags = parse_header(f.readline(), path)
        w, h = int(tags["W"]), int(tags["H"])
        size = w * h * 3 // 2
        n = 0
        while max_frames is None or n < max_frames:
            marker = f.readline()
            if not marker:
                return
            if not marker.startswith(b"FRAME"):
                raise ValueError(f"{path}: frame {n} does not start with FRAME ({marker[:16]!r})")
            buf = f.read(size)
            if len(buf) < size:
                return
            yield i420_to_bgr(np.frombuffer(buf, np.uint8), h, w)
            n += 1


def write_y4m(path: str, frames_bgr: Iterable[np.ndarray], fps: int = 30) -> int:
    """Write BGR uint8 frames (all one even size) as a 4:2:0 ``.y4m``;
    returns the number of frames written."""
    n = 0
    with open(path, "wb") as f:
        planes = None
        for frame in frames_bgr:
            h, w = frame.shape[:2]
            if planes is None:
                if h % 2 or w % 2:
                    raise ValueError(f"{path}: frame size {w}x{h} is not even")
                f.write(b"%s W%d H%d F%d:1 Ip A1:1 C420jpeg\n" % (MAGIC, w, h, int(fps)))
                planes = np.empty(h * w * 3 // 2, np.uint8)
                shape = (h, w)
            elif (h, w) != shape:
                raise ValueError(f"{path}: frame {n} is {w}x{h}, not {shape[1]}x{shape[0]}")
            rgb_to_i420(np.ascontiguousarray(frame[..., ::-1]), planes)
            f.write(b"FRAME\n")
            f.write(planes.tobytes())
            n += 1
    return n
