"""Frame sources for the live application.

Port of ``stdd_tpu/runtime/sources.py`` (``iter_synthetic`` :68,
``iter_screen`` :82, ``throttle`` :100). The reference's capture layer is
Windows-only (PrintWindow/BitBlt window grabs in ``test/win_capture.py``);
here a source is any iterator of BGR uint8 ``[H, W, 3]`` frames. The live
call's source is X11 capture (:mod:`stdd_torch.runtime.x11_capture`, pure
sockets and numpy). The video-file and webcam sources and the largest-tile
picker (``LargestTilePicker``/``iter_roi``) need cv2, which the port does
not use; ROADMAP.md queues them.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

FrameIter = Iterator[np.ndarray]


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
