"""Live-call application loop (the reference's test/app_realtime.py).

Port of ``stdd_tpu/runtime/app.py``, headless: the engine consumes any
frame source of :mod:`stdd_torch.runtime.sources`, and the meeting-level
verdict logic matches the reference:

- self-view exclusion rect in normalized coords (af_realtime.py:311)
- interlocutor = largest non-self-view face (``pick_interlocutor_id``
  af_realtime.py:279)
- meeting verdict: any track with ≥128 frames whose p80 running score clears
  the threshold (app_realtime.py:75 decide_meeting_fake)

The overlay (``draw_overlay``), ``--show`` and ``--out_video`` draw with cv2,
which the port does not use; they and the cv2 sources wait in ROADMAP.md,
and their flags are refused by name rather than ignored.

CLI, on the card: ``python -m stdd_torch.runtime.app --source screen:TITLE
--det_model face_detection_yunet_2023mar.onnx [--jax_ckpt CKPT]``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..config import DetectorConfig, PipelineConfig
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
    """Engine + running-score bookkeeping + meeting verdict."""

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


def run_loop(app: RealtimeApp, frames: Iterable[np.ndarray]) -> Tuple[bool, bool]:
    """Drive the app over a frame source; returns the final meeting verdict
    (app_realtime.py:96 run_loop, minus the Windows window plumbing and the
    overlay)."""
    for frame in frames:
        app.step(frame)
    app.flush()
    return app.meeting_verdict()


# flags of the JAX CLI whose parts are not ported yet: refused, never ignored
_CV2_ITEM = "ROADMAP.md §1 item 2, the pieces of the detector and the app that wait"
_NOT_PORTED = {
    "--show": f"the cv2 overlay window ({_CV2_ITEM})",
    "--out_video": f"the cv2 overlay and video writer ({_CV2_ITEM})",
    "--ckpt": "utils/torch_convert.py, the reference-checkpoint loader "
              "(ROADMAP.md §1 item 3, eval harnesses)",
    "--int8": "the int8 serving knob (ROADMAP.md §1 item 9)",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", required=True,
                    help="'screen' (X11 full screen) | 'screen:TITLE' (largest "
                         "window whose title contains TITLE, e.g. screen:Teams)")
    ap.add_argument("--capture_hz", type=float, default=8.0,
                    help="screen-capture pacing (win_capture.py target_hz)")
    ap.add_argument("--det_model", default=None,
                    help="YuNet ONNX file (default: models/yunet.py DEFAULT_MODEL)")
    ap.add_argument("--ckpt", default=None, help="not ported: " + _NOT_PORTED["--ckpt"])
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
                    help="not ported: " + _NOT_PORTED["--out_video"])
    ap.add_argument("--upload_format", default="rgb", choices=["rgb", "yuv420"],
                    help="crop upload format; yuv420 halves host->device bytes")
    ap.add_argument("--int8", action="store_true", help="not ported: " + _NOT_PORTED["--int8"])
    ap.add_argument("--model_crop", type=int, default=None,
                    help="crop size the --jax_ckpt was trained at (default: "
                         "the checkpoint's sidecar metadata, else 224)")
    ap.add_argument("--no_warmup", dest="warmup", action="store_false",
                    help="skip the startup run of every scorer batch shape")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run into DIR "
                         "(chrome trace JSON)")
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

    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag[2:]):
            raise SystemExit(f"{flag} is not ported yet: it waits for {why}")
    if not (args.source == "screen" or args.source.startswith("screen:")):
        raise SystemExit(
            f"--source {args.source!r}: the port reads X11 capture only ('screen' or "
            f"'screen:TITLE'); video files and webcams wait for the cv2 sources ({_CV2_ITEM})")

    import torch

    from ..models.yunet import DEFAULT_MODEL, YuNet, detect_scaled
    from . import sources
    from .classifier import ClipScorer
    from .engine import AsyncDetector

    kw = dict(upload_format=args.upload_format, device=args.device)
    if args.jax_ckpt:
        from ..config import I3DConfig

        # geometry: --model_crop wins; else the checkpoint's sidecar
        # metadata (cfg=None); else the default 224
        cfg = None
        if args.model_crop:
            cfg = I3DConfig(num_frames=args.clip_size, crop_size=args.model_crop)
        elif not os.path.exists(args.jax_ckpt + ".json"):
            cfg = I3DConfig(num_frames=args.clip_size)
        scorer = ClipScorer.from_jax_checkpoint(args.jax_ckpt, cfg=cfg, **kw)
    else:
        scorer = ClipScorer.random_init(**kw)
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
    title = args.source.split(":", 1)[1] if ":" in args.source else None
    frames = sources.iter_screen(
        window_title=(title,) if title else None,
        target_hz=args.capture_hz, max_frames=args.max_frames,
    )

    activities = [torch.profiler.ProfilerActivity.CPU]
    if scorer.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = (torch.profiler.profile(activities=activities) if args.profile
            else contextlib.nullcontext())
    try:
        with prof:
            ready, fake = run_loop(app, frames)
    finally:
        engine.close()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    print(f"meeting verdict: ready={ready} fake={fake}")


if __name__ == "__main__":
    main()
