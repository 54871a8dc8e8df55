"""YUV4MPEG2 (``.y4m``) video reader and writer, without cv2.

The JAX package reads video through ``cv2.VideoCapture``
(``stdd_tpu/data/preprocess.py``, ``stdd_tpu/utils/video_io.py``); the port
may not import cv2, so its video files are ``.y4m``: a text header, then
each frame as ``FRAME`` and planar I420 bytes (Y, then U and V at quarter
size). :func:`read_y4m` decodes 4:2:0 to BGR uint8 with the integer
arithmetic of ``cv2.cvtColor(COLOR_YUV2BGR_I420)`` (BT.601 video range, Q20,
nearest-neighbour chroma), so a frame is bit-equal to that conversion of the
same planes. :func:`write_y4m` (and :class:`Y4mWriter`, frame by frame) encodes with the port's I420 encoder
(``runtime/packing.py::rgb_to_i420``, bit-equal to
``cv2.cvtColor(COLOR_RGB2YUV_I420)``).

The helpers of ``stdd_tpu/utils/video_io.py`` (the reference's
``test_tools/ct/detection/utils.py`` and ``__init__.py``) follow on
``.y4m``: :func:`grab_all_frames`, :func:`get_clips_uniform` (which
decodes only the frames its clips need) and :func:`scale_detect` (through
``ops/align.py::resize_u8``, bit-equal to ``cv2.resize``), and the pure
ones, :func:`sample_chunks`, :func:`weak_check`, :func:`check_valid_face`
and :func:`get_valid_faces`.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.align import resize_u8
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


def iter_y4m_planes(path: str, max_frames: Optional[int] = None
                    ) -> Iterator[Tuple[bytes, int, int]]:
    """Yield each frame's raw I420 bytes with the frame's height and width,
    undecoded. A truncated last frame ends the stream, as a decoder's read
    would."""
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
            yield buf, h, w
            n += 1


def read_y4m(path: str, max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield the BGR uint8 frames of a ``.y4m`` file, at most
    ``max_frames``. A truncated last frame ends the stream, as a decoder's
    read would."""
    for buf, h, w in iter_y4m_planes(path, max_frames):
        yield i420_to_bgr(np.frombuffer(buf, np.uint8), h, w)


def count_y4m_frames(path: str) -> int:
    """The number of whole frames of a ``.y4m`` file. When the first frame
    header is a bare ``FRAME`` (no parameters) and the body is a whole
    number of frames, the count comes from the file's size; otherwise the
    file is scanned, header by header, without decoding."""
    with open(path, "rb") as f:
        header = f.readline()
        tags = parse_header(header, path)
        first = f.readline()
    size = int(tags["W"]) * int(tags["H"]) * 3 // 2
    body = os.path.getsize(path) - len(header)
    if first == b"FRAME\n" and body % (len(first) + size) == 0:
        return body // (len(first) + size)
    return sum(1 for _ in iter_y4m_planes(path))


class Y4mWriter:
    """A 4:2:0 ``.y4m`` written frame by frame (the role of
    ``cv2.VideoWriter``): the header goes out with the first frame, whose
    size (even) every later frame must have."""

    def __init__(self, path: str, fps: int = 30):
        self.path, self.fps, self.count = path, int(fps), 0
        self._f = open(path, "wb")
        self._planes: Optional[np.ndarray] = None
        self._shape: Optional[Tuple[int, int]] = None

    def write(self, frame_bgr: np.ndarray) -> None:
        h, w = frame_bgr.shape[:2]
        if self._planes is None:
            if h % 2 or w % 2:
                raise ValueError(f"{self.path}: frame size {w}x{h} is not even")
            self._f.write(b"%s W%d H%d F%d:1 Ip A1:1 C420jpeg\n" % (MAGIC, w, h, self.fps))
            self._planes = np.empty(h * w * 3 // 2, np.uint8)
            self._shape = (h, w)
        elif (h, w) != self._shape:
            raise ValueError(f"{self.path}: frame {self.count} is {w}x{h}, "
                             f"not {self._shape[1]}x{self._shape[0]}")
        rgb_to_i420(np.ascontiguousarray(frame_bgr[..., ::-1]), self._planes)
        self._f.write(b"FRAME\n")
        self._f.write(self._planes.tobytes())
        self.count += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Y4mWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_y4m(path: str, frames_bgr: Iterable[np.ndarray], fps: int = 30) -> int:
    """Write BGR uint8 frames (all one even size) as a 4:2:0 ``.y4m``;
    returns the number of frames written."""
    with Y4mWriter(path, fps) as w:
        for frame in frames_bgr:
            w.write(frame)
        return w.count


# -- the reference's video and detection helpers -------------------------------

def grab_all_frames(path: str, max_size: int, cvt: bool = False) -> List[np.ndarray]:
    """Decode up to ``max_size`` frames (all of them when ``max_size`` < 1,
    as the reference's count never meets it); ``cvt`` flips BGR→RGB
    (detection/utils.py:17)."""
    frames = read_y4m(path, max_size if max_size >= 1 else None)
    return [f[..., ::-1].copy() if cvt else f for f in frames]


def sample_chunks(items: Sequence, n: int, step: Optional[int] = None) -> List:
    """Fixed-size windows at a stride (detection/utils.py:13)."""
    step = step or n
    return [items[i : i + n] for i in range(0, len(items), step) if i + n <= len(items)]


def get_clips_uniform(path: str, count: int, clip_size: int) -> List[List[np.ndarray]]:
    """``count`` uniformly spaced ``clip_size``-frame clips
    (detection/utils.py:33); only the frames the clips hold are decoded."""
    n_frames = count_y4m_frames(path)
    max_clips = n_frames + 1 - clip_size
    if max_clips <= 0:
        return []
    count = min(count, max_clips)
    starts = np.linspace(0, max_clips - 1, count, endpoint=True, dtype=int)
    all_idx = [list(range(s, s + clip_size)) for s in starts]
    valid = {i for clip in all_idx for i in clip}
    frames: Dict[int, np.ndarray] = {}
    for idx, (buf, h, w) in enumerate(iter_y4m_planes(path, max(valid) + 1)):
        if idx in valid:
            frames[idx] = i420_to_bgr(np.frombuffer(buf, np.uint8), h, w)
    return [
        [frames[i] for i in clip]
        for clip in all_idx
        if all(i in frames for i in clip)
    ]


def weak_check(detect_res: Sequence[Sequence]) -> bool:
    """At least ~0.75 faces per frame on average (test_tools/utils.py:9)."""
    return sum(len(faces) for faces in detect_res) > len(detect_res) * 0.75


def _bounded(v, lo, hi) -> bool:
    return lo <= v <= hi


def check_valid_face(face, w: int, h: int) -> bool:
    """Box/landmarks inside the frame (detection/__init__.py:10)."""
    box, pts = face[0], face[1]
    if box[0] > box[2] or box[1] > box[3]:
        return False
    for idx, bound in zip(range(4), (w, h, w, h)):
        if not _bounded(box[idx], 0, bound):
            return False
    for p in pts:
        if not (_bounded(p[0], 0, w) and _bounded(p[1], 0, h)):
            return False
    return True


def get_valid_faces(detect_results, w: int, h: int, scale: float = 1.0):
    """Rescale detections to frame coords and drop out-of-frame faces
    (detection/__init__.py:27 post_detect)."""
    out = []
    for frame_faces in detect_results:
        kept = []
        for box, lm, score in frame_faces:
            face = (np.asarray(box) * scale, np.asarray(lm) * scale, score)
            if check_valid_face(face, w=w, h=h):
                kept.append(face)
        out.append(kept)
    return out


def scale_detect(detector, images: Sequence[np.ndarray], max_res: int = 1920):
    """Resolution-capped detection (detection/__init__.py:41
    FaceDetector.scale_detect): cap the long side at ``max_res``, detect at
    half that resolution, rescale results back.

    ``detector(frames) -> per-frame [(box, lm5, score)]`` at the detect
    resolution.
    """
    h, w = images[0].shape[:2]
    init_scale = max(h, w) / max_res if max(h, w) > max_res else 1
    resize_scale = 2 * init_scale
    rw, rh = int(w / resize_scale), int(h / resize_scale)
    small = [resize_u8(f, (rh, rw)) for f in images]
    return get_valid_faces(detector(small), w=w, h=h, scale=resize_scale)
