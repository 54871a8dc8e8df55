"""Frame sources for the live application.

Port of ``stdd_tpu/runtime/sources.py`` (``iter_video_file`` :22,
``iter_synthetic`` :68, ``iter_screen`` :82, ``throttle`` :100,
``LargestTilePicker`` :114, ``iter_roi`` :153). The
reference's capture layer is Windows-only (PrintWindow/BitBlt window grabs
in ``test/win_capture.py``); here a source is any iterator of BGR uint8
``[H, W, 3]`` frames. The live call's source is X11 capture
(:mod:`stdd_torch.runtime.x11_capture`, pure sockets and numpy); the
offline stand-in is a ``.y4m`` file (:func:`iter_video_file`). The webcam
source has no camera API the port may use (ROADMAP.md §1 item 2). The
largest-tile picker (``LargestTilePicker`` :114, ``iter_roi`` :153) cuts a
grid-layout call down to its dominant tile with the numpy twins of cv2's
Canny, dilation and contours (:mod:`stdd_torch.ops.edges`), and returns the
JAX picker's rectangles.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

from ..ops.edges import canny, dilate3x3, external_bounding_rects
from ..utils.draw import absdiff, to_gray

FrameIter = Iterator[np.ndarray]


def iter_video_file(path: str, loop: bool = False, max_frames: Optional[int] = None) -> FrameIter:
    """Frames of a ``.y4m`` file (the offline stand-in for window capture),
    from the start again after the last when ``loop``, at most
    ``max_frames`` in all. A file with no frame raises, so ``loop`` cannot
    spin. Another container raises a ``ValueError`` naming it: its decoder
    is not ported (ROADMAP.md §1 item 2)."""
    from ..utils.video_io import read_y4m

    if not path.lower().endswith(".y4m"):
        raise ValueError(f"{path}: the port reads video files as YUV4MPEG2 (.y4m) only; "
                         "decoding .mp4/.avi/.mov/.mkv waits for a decoder "
                         "(ROADMAP.md §1 item 2)")
    n = 0
    while True:
        n_this_pass = 0
        for frame in read_y4m(path):
            yield frame
            n += 1
            n_this_pass += 1
            if max_frames is not None and n >= max_frames:
                return
        if n_this_pass == 0:
            raise RuntimeError(f"no frames decodable from {path!r}")
        if not loop:
            return


def iter_synthetic(
    n_frames: int, hw: Tuple[int, int] = (720, 1280), seed: int = 0,
    draw: Optional[Callable[[np.ndarray, int], None]] = None,
) -> FrameIter:
    """Deterministic synthetic stream for tests/benches."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, hw + (3,), np.uint8)
    for i in range(n_frames):
        frame = base.copy()
        if draw is not None:
            draw(frame, i)
        yield frame


def iter_screen(
    display: Optional[str] = None,
    window_title: Optional[Tuple[str, ...]] = None,
    region: Optional[Tuple[int, int, int, int]] = None,
    target_hz: float = 8.0,
    max_frames: Optional[int] = None,
) -> FrameIter:
    """Live X11 screen/window capture (Linux analogue of the reference's
    ``iter_window_frames``/``iter_teams_frames``, win_capture.py:42,:121).
    See :mod:`stdd_torch.runtime.x11_capture`."""
    from .x11_capture import iter_screen_frames

    return iter_screen_frames(
        display=display, window_title=window_title, region=region,
        target_hz=target_hz, max_frames=max_frames,
    )


def throttle(frames: Iterable[np.ndarray], target_hz: float) -> FrameIter:
    """Rate-limit a source to a target frequency (run_loop's pacing,
    app_realtime.py:96)."""
    period = 1.0 / max(target_hz, 1e-6)
    last = 0.0
    for f in frames:
        now = time.perf_counter()
        wait = period - (now - last)
        if wait > 0:
            time.sleep(wait)
        last = time.perf_counter()
        yield f


class LargestTilePicker:
    """Pick the dominant video tile in a grid-layout call UI
    (capture_tile.py:55): edge-density segmentation into rectangles, choose
    the largest; fall back to the motion bounding box."""

    def __init__(self, min_area_frac: float = 0.08, motion_thresh: float = 12.0):
        self.min_area_frac = min_area_frac
        self.motion_thresh = motion_thresh
        self._prev: Optional[np.ndarray] = None

    def pick(self, frame_bgr: np.ndarray) -> Tuple[int, int, int, int]:
        H, W = frame_bgr.shape[:2]
        gray = to_gray(frame_bgr)
        edges = dilate3x3(canny(gray, 60, 160))
        best, best_area = None, 0
        for x, y, w, h in external_bounding_rects(255 - edges):
            area = w * h
            if area > best_area and area >= self.min_area_frac * H * W:
                best, best_area = (x, y, x + w, y + h), area
        # refresh the motion reference on every call: a tile hit that
        # skipped it would leave the fallback diffing against a frame from
        # minutes ago, flagging the whole screen as motion
        prev, self._prev = self._prev, gray
        if best is not None:
            return best
        if prev is not None:                                     # motion fallback
            ys, xs = np.where(absdiff(gray, prev) > self.motion_thresh)
            if len(xs) > 100:
                return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())
        return 0, 0, W, H


def iter_roi(frames: Iterable[np.ndarray], picker: Optional[LargestTilePicker] = None,
             repick_every: int = 30) -> FrameIter:
    """Crop each frame to the picked tile (capture_tile.py:147
    iter_roi_frames), picking again every ``repick_every`` frames."""
    picker = picker or LargestTilePicker()
    roi = None
    for i, f in enumerate(frames):
        if roi is None or i % repick_every == 0:
            roi = picker.pick(f)
        x1, y1, x2, y2 = roi
        yield f[y1:y2, x1:x2]
