"""Live-call application loop (the reference's test/app_realtime.py).

Port of ``stdd_tpu/runtime/app.py``: the engine consumes any frame source
of :mod:`stdd_torch.runtime.sources`, and the meeting-level verdict logic
matches the reference:

- self-view exclusion rect in normalized coords (af_realtime.py:311)
- interlocutor = largest non-self-view face (``pick_interlocutor_id``
  af_realtime.py:279)
- meeting verdict: any track with ≥128 frames whose p80 running score clears
  the threshold (app_realtime.py:75 decide_meeting_fake)
- per-track hysteresis overlay colors (0.75/0.65)

The overlay (``draw_overlay``) draws with :mod:`stdd_torch.utils.draw`,
bit-equal to the JAX package's cv2 calls, and ``--out_video PATH.y4m``
writes it at 30 fps; ``--int8`` scores through the int8 convolutions of
s3-s5. A window (``--show``), webcams and video containers other than
``.y4m`` stay refused by name (ROADMAP.md §1 item 2).

CLI, on the card: ``python -m stdd_torch.runtime.app --source screen:TITLE
--det_model face_detection_yunet_2023mar.onnx [--ckpt REF.pth | --jax_ckpt CKPT]``,
or ``--source VIDEO.y4m [--out_video OVERLAY.y4m]`` to score a file.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..config import DetectorConfig, PipelineConfig
from ..utils import draw
from ..utils.video_io import Y4mWriter
from .engine import StreamingEngine
from .scoring import decide_meeting_fake


def in_exclude_rect(box, H: int, W: int, rect: Tuple[float, float, float, float]) -> bool:
    """Box center inside the normalized self-view rect (af_realtime.py:311)."""
    x1, y1, x2, y2 = box
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    rx1, ry1, rx2, ry2 = rect
    return (rx1 * W <= cx <= rx2 * W) and (ry1 * H <= cy <= ry2 * H)


def pick_interlocutor(
    last_boxes: Dict[int, np.ndarray], H: int, W: int,
    exclude_rect: Tuple[float, float, float, float] = (0.70, 0.70, 1.00, 1.00),
) -> Optional[int]:
    """Largest face outside the self-view; falls back to largest overall
    (af_realtime.py:279)."""
    if not last_boxes:
        return None
    cand = [
        (tid, (b[2] - b[0]) * (b[3] - b[1]))
        for tid, b in last_boxes.items()
        if not in_exclude_rect(b, H, W, exclude_rect)
    ]
    if not cand:
        cand = [(tid, (b[2] - b[0]) * (b[3] - b[1])) for tid, b in last_boxes.items()]
    return max(cand, key=lambda t: t[1])[0]


class RealtimeApp:
    """Engine + running-score bookkeeping + meeting verdict + overlay."""

    def __init__(
        self,
        engine: StreamingEngine,
        threshold: float = 0.362,
        exclude_rect: Tuple[float, float, float, float] = (0.70, 0.70, 1.00, 1.00),
        decision_min_frames: int = 128,
        decision_percentile: float = 80.0,
    ):
        self.engine = engine
        self.threshold = threshold
        self.exclude_rect = exclude_rect
        self.decision_min_frames = decision_min_frames
        self.decision_percentile = decision_percentile
        self.frames_seen = 0

    @property
    def running_scores(self) -> Dict[int, list]:
        """Per-track clip scores — read straight from the engine (which
        already accumulates every harvested score); a second copy here
        could silently diverge when a peer thread harvests between steps."""
        return self.engine.track_clip_scores

    def step(self, frame_bgr: np.ndarray):
        results = self.engine.step(frame_bgr)
        self.frames_seen += 1
        return results

    def flush(self):
        """Drain in-flight async batches into the running scores."""
        return self.engine.flush()

    @property
    def last_boxes(self) -> Dict[int, np.ndarray]:
        return {
            t.track_id: t.tlbr
            for t in self.engine.tracker.tracked
            if t.is_activated
        }

    def meeting_verdict(self) -> Tuple[bool, bool]:
        """(any track has enough evidence, meeting judged fake)."""
        frames = dict(self.engine.track_frames)
        ready = any(
            n >= self.decision_min_frames and self.running_scores.get(t)
            for t, n in frames.items()
        )
        fake = decide_meeting_fake(
            self.running_scores, frames, self.threshold,
            self.decision_min_frames, self.decision_percentile,
        )
        return ready, fake


    def draw_overlay(self, frame_bgr: np.ndarray) -> np.ndarray:
        """The frame with each live track's box (red when its hysteresis
        says fake, else green), its id, latest score and the interlocutor's
        ``*``, and the meeting verdict at the top left."""
        out = frame_bgr.copy()
        H, W = out.shape[:2]
        inter = pick_interlocutor(self.last_boxes, H, W, self.exclude_rect)
        for tid, box in self.last_boxes.items():
            x1, y1, x2, y2 = np.rint(box).astype(int)
            fake = self.engine.hysteresis.fake.get(tid, False)
            color = (0, 0, 255) if fake else (0, 255, 0)
            draw.rectangle(out, (x1, y1), (x2, y2), color, 2)
            scores = self.running_scores.get(tid, [])
            label = f"id{tid}"
            if scores:
                label += f" {scores[-1]:.2f}"
            if tid == inter:
                label += " *"
            draw.put_text(out, label, (x1, max(12, y1 - 6)), draw.FONT_HERSHEY_SIMPLEX, 0.5,
                          color, 1)
        ready, fake = self.meeting_verdict()
        verdict = "FAKE" if (ready and fake) else ("REAL" if ready else "...")
        draw.put_text(out, f"meeting: {verdict}", (8, 22), draw.FONT_HERSHEY_SIMPLEX, 0.7,
                      (0, 0, 255) if verdict == "FAKE" else (0, 255, 0), 2)
        return out


def run_loop(
    app: RealtimeApp,
    frames: Iterable[np.ndarray],
    show: bool = False,
    out_video: Optional[str] = None,
    on_frame=None,
) -> Tuple[bool, bool]:
    """Drive the app over a frame source; returns the final meeting verdict
    (app_realtime.py:96 run_loop, minus the Windows window plumbing). Each
    frame is stepped, then, when anything reads it, overlaid, handed to
    ``on_frame`` and written to ``out_video`` (a ``.y4m`` at 30 fps, as the
    JAX writer's rate); then in-flight batches are flushed. ``show`` (a
    window) is refused: no window API is open to the port."""
    if show:
        raise ValueError(f"run_loop(show=True): {_NOT_PORTED['--show']}")
    if out_video and not out_video.lower().endswith(".y4m"):
        raise ValueError(f"out_video {out_video!r}: {_NOT_PORTED['--out_video']}")
    writer = None
    try:
        for frame in frames:
            app.step(frame)
            if out_video or on_frame:
                overlay = app.draw_overlay(frame)
                if on_frame:
                    on_frame(overlay)
                if out_video:
                    if writer is None:
                        writer = Y4mWriter(out_video, fps=30)
                    writer.write(overlay)
        app.flush()
        return app.meeting_verdict()
    finally:
        if writer is not None:
            writer.close()


# parts of the JAX CLI the port refuses by name, never ignores
_CV2_ITEM = "ROADMAP.md §1 item 2"
_NOT_PORTED = {
    "--show": f"the overlay's window (cv2.imshow) has no window API open to the port ({_CV2_ITEM})",
    "--out_video": ("the overlay is written as YUV4MPEG2 (.y4m) only; encoding "
                    f".mp4/.avi/.mov/.mkv waits for an encoder ({_CV2_ITEM})"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", required=True,
                    help="video path (.y4m) | 'screen' (X11 full screen) | "
                         "'screen:TITLE' (largest window whose title contains "
                         "TITLE, e.g. screen:Teams)")
    ap.add_argument("--capture_hz", type=float, default=8.0,
                    help="screen-capture pacing (win_capture.py target_hz)")
    ap.add_argument("--det_model", default=None,
                    help="YuNet ONNX file (default: models/yunet.py DEFAULT_MODEL)")
    ap.add_argument("--ckpt", default=None,
                    help="reference .pth checkpoint (converted on load)")
    ap.add_argument("--jax_ckpt", default=None,
                    help="msgpack checkpoint trained by stdd_tpu.train.run_i3d "
                         "(or written by stdd_torch.utils.checkpoint)")
    ap.add_argument("--threshold", type=float, default=0.362)
    ap.add_argument("--clip_size", type=int, default=32)
    ap.add_argument("--stride", type=int, default=30)
    ap.add_argument("--detect_every", type=int, default=4)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--show", action="store_true", help="not ported: " + _NOT_PORTED["--show"])
    ap.add_argument("--out_video", default=None,
                    help="write the overlay to this .y4m at 30 fps (other containers: "
                         "not ported, ROADMAP.md §1 item 2)")
    ap.add_argument("--upload_format", default="rgb", choices=["rgb", "yuv420"],
                    help="crop upload format; yuv420 halves host->device bytes")
    ap.add_argument("--int8", action="store_true",
                    help="int8 dynamic-quant convs for the wide I3D stages "
                         "(s3-s5); scores shift by the quantization error")
    ap.add_argument("--arch", default="i3d_ori", choices=["i3d_ori", "ftcn_tt"],
                    help="the served model: AltFreezing's I3D-ResNet50 (default) or "
                         "FTCN-TT, the temporal-only trunk with the time-transformer head")
    ap.add_argument("--model_crop", type=int, default=None,
                    help="crop size the --jax_ckpt was trained at (default: "
                         "the checkpoint's sidecar metadata, else 224)")
    ap.add_argument("--no_warmup", dest="warmup", action="store_false",
                    help="skip the startup run of every scorer batch shape")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run, every thread's "
                         "spans included, to DIR/trace.json (chrome trace JSON)")
    ap.add_argument("--max_batch_wait", type=int, default=None,
                    help="ship a partial clip batch after this many frames "
                         "(default: stride — a 1-face call must not wait for "
                         "a full batch to see its first score); <=0 disables")
    ap.add_argument("--no_stagger", dest="stagger", action="store_false",
                    help="disable per-track window-phase staggering (on by "
                         "default: co-appearing faces spread their stride "
                         "ticks so n faces never dispatch n windows at once)")
    ap.add_argument("--early_window", type=float, default=0.0, metavar="FRAC",
                    help="dispatch one provisional window per new track once "
                         "ceil(clip_size*FRAC) frames are buffered (padded "
                         "with the newest frame, TEST2.py:358 semantics); 0 "
                         "disables (default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the detector and the scorer (default: the card)")
    args = ap.parse_args(argv)

    if args.show:
        raise SystemExit(f"--show is not ported yet: {_NOT_PORTED['--show']}")
    if args.out_video and not args.out_video.lower().endswith(".y4m"):
        raise SystemExit(f"--out_video {args.out_video!r}: {_NOT_PORTED['--out_video']}")
    screen = args.source == "screen" or args.source.startswith("screen:")
    if args.source.startswith("webcam"):
        raise SystemExit(f"--source {args.source!r}: webcams stay unported, as no camera API "
                         "is open to the port (ROADMAP.md §1 item 2); use 'screen', "
                         "'screen:TITLE' or a .y4m file")
    if not screen and not args.source.lower().endswith(".y4m"):
        raise SystemExit(f"--source {args.source!r}: the port reads video files as YUV4MPEG2 "
                         "(.y4m) only; decoding other containers waits for a decoder "
                         "(ROADMAP.md §1 item 2)")

    import torch

    from ..models.yunet import DEFAULT_MODEL, YuNet, detect_scaled
    from ..utils.misc import check_device, profiler_trace
    from . import sources
    from .classifier import load_scorer
    from .engine import AsyncDetector

    check_device(args.device, "app")
    scorer = load_scorer(args.ckpt, args.jax_ckpt, args.clip_size, args.model_crop,
                         arch=args.arch, upload_format=args.upload_format,
                         device=args.device, int8=args.int8)
    # the detector's float32 convolutions run without TF32 (cuDNN's default
    # would take it), the precision its card-vs-CPU parity holds them to;
    # the scorer computes in bf16 and does not read the flag
    torch.backends.cudnn.allow_tf32 = False
    det = YuNet(args.det_model or DEFAULT_MODEL, DetectorConfig(), device=args.device)

    def detect_fn(frame_bgr):
        return detect_scaled(det, frame_bgr)

    cfg = PipelineConfig(
        clip_size=args.clip_size, stride=args.stride,
        detect_every=args.detect_every, threshold=args.threshold,
    )
    # flag unset → the engine's "stride" sentinel: 0 (ship at once) in
    # device-ring mode, where a window dispatch carries no pixels
    if args.max_batch_wait is None:
        wait = "stride"
    else:
        wait = args.max_batch_wait if args.max_batch_wait > 0 else None
    engine = StreamingEngine(
        scorer, AsyncDetector(detect_fn), cfg=cfg,
        max_batch_wait_frames=wait,
        stagger_windows=args.stagger,
        early_window_frac=args.early_window,
    )
    if args.warmup and scorer.device.type == "cuda":
        # run every batch capacity the engine can dispatch once, so the
        # first clips of a live call do not pay K1's build and cuDNN's
        # algorithm choice
        print("warming up scorer...")
        engine.warmup()
    app = RealtimeApp(engine, threshold=args.threshold)
    if screen:
        title = args.source.split(":", 1)[1] if ":" in args.source else None
        frames = sources.iter_screen(
            window_title=(title,) if title else None,
            target_hz=args.capture_hz, max_frames=args.max_frames,
        )
    else:
        frames = sources.iter_video_file(args.source, max_frames=args.max_frames)

    prof = profiler_trace(args.profile) if args.profile else contextlib.nullcontext()
    try:
        with prof:
            ready, fake = run_loop(app, frames, out_video=args.out_video)
    finally:
        engine.close()
    print(f"frames: {app.frames_seen}")
    print(f"meeting verdict: ready={ready} fake={fake}")
    print("stats: " + " ".join(f"{k}={v}" for k, v in engine.stats().items()))


if __name__ == "__main__":
    main()
