"""Detection / track / landmark visualization (the reference's YuNet demo,
``preprocessing/yunet/demoYunet.py:104``, extended to tracks + dense
landmarks).

Port of ``stdd_tpu/eval/viz.py``, drawing with :mod:`stdd_torch.utils.draw`
(bit-equal to the JAX package's cv2 calls):

- :func:`visualize_detections` — boxes, confidences, 5-pt landmarks with the
  reference's color scheme (per-landmark colors, green box, red text);
- :func:`visualize_tracks` — per-track-id colored boxes over time;
- :func:`draw_dense_landmarks` — a dense landmark set as filled dots;
- CLI: annotate a PNG image or a ``.y4m`` video with detections (+ optional
  tracking and the packaged dense landmarker) and write the result (PNG, or
  ``.y4m`` at the input's rate), on the card unless ``--device cpu``::

      python -m stdd_torch.eval.viz --input in.y4m --output out.y4m \
          --det_model yunet.onnx [--track] [--dense_landmarks] [--max_frames N]

  Other containers are refused, naming ROADMAP.md §1 item 2.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils import draw

# per-landmark colors, BGR (demoYunet.py:106): right eye, left eye, nose
# tip, right mouth corner, left mouth corner
LANDMARK_COLORS = [
    (255, 0, 0), (0, 0, 255), (0, 255, 0), (255, 0, 255), (0, 255, 255),
]


def visualize_detections(image_bgr, rows, box_color=(0, 255, 0),
                         text_color=(0, 0, 255), fps: Optional[float] = None):
    """Draw [N, 15] detector rows (x, y, w, h, 5×(lx, ly), conf) — the
    reference ``visualize`` (demoYunet.py:104)."""
    out = image_bgr.copy()
    if fps is not None:
        draw.put_text(out, f"FPS: {fps:.2f}", (0, 15), draw.FONT_HERSHEY_SIMPLEX, 0.5,
                      text_color)
    for det in np.asarray(rows).reshape(-1, 15):
        x, y, w, h = det[:4].astype(np.int32)
        draw.rectangle(out, (x, y), (x + w, y + h), box_color, 2)
        draw.put_text(out, f"{det[14]:.4f}", (x, y + 12), draw.FONT_HERSHEY_DUPLEX, 0.5,
                      text_color)
        for idx, (lx, ly) in enumerate(det[4:14].reshape(5, 2).astype(np.int32)):
            draw.circle(out, (int(lx), int(ly)), 2, LANDMARK_COLORS[idx], 2)
    return out


def _track_color(tid: int):
    rng = np.random.RandomState(tid * 7919 + 13)
    return tuple(int(c) for c in rng.randint(60, 255, 3))


def visualize_tracks(image_bgr, tracks, probs: Optional[dict] = None):
    """Draw live tracks: per-id colored box + id (+ latest deepfake prob)."""
    out = image_bgr.copy()
    for tr in tracks:
        x1, y1, x2, y2 = np.asarray(tr.tlbr[:4]).astype(np.int32)
        col = _track_color(tr.track_id)
        draw.rectangle(out, (x1, y1), (x2, y2), col, 2)
        label = f"id {tr.track_id}"
        if probs and tr.track_id in probs:
            label += f"  p={probs[tr.track_id]:.2f}"
        draw.put_text(out, label, (x1, max(12, y1 - 6)), draw.FONT_HERSHEY_SIMPLEX, 0.5, col, 2)
    return out


def draw_dense_landmarks(image_bgr, pts, color=(0, 200, 255), copy=True):
    """Scatter a [N, 2] dense landmark set (FaceMesh layout). Returns an
    annotated copy like the sibling visualize_* helpers (pass ``copy=False``
    to draw onto ``image_bgr`` in place)."""
    out = image_bgr.copy() if copy else image_bgr
    for x, y in np.asarray(pts, np.int32):
        draw.circle(out, (int(x), int(y)), 1, color, -1)
    return out


def make_annotator(detect_fn, tracker=None, landmarker=None):
    """``frame_bgr → annotated copy``, as the JAX CLI's ``annotate``:
    ``detect_fn`` gives [N, 15] rows; with a tracker, boxes are colored per
    track id (the tracker is fed empty frames too); with a landmarker, each
    detection's dense points are drawn."""

    def annotate(frame_bgr):
        rows = detect_fn(frame_bgr)
        if tracker is not None:
            # feed empty frames too: the tracker ages tracked→lost→removed
            # by frame count, so a detection gap must still tick frame_id
            # (else a new face later IoU-matches a stale box and inherits
            # the dead track's id)
            tlbr = (np.stack([rows[:, 0], rows[:, 1], rows[:, 0] + rows[:, 2],
                              rows[:, 1] + rows[:, 3], rows[:, 14]], axis=1)
                    if rows.size else np.zeros((0, 5), np.float32))
            out = visualize_tracks(frame_bgr, tracker.update(tlbr))
        else:
            out = visualize_detections(frame_bgr, rows) if rows.size else frame_bgr.copy()
        if landmarker is not None and rows.size:
            for r in rows.reshape(-1, 15):
                pts = landmarker(frame_bgr[:, :, ::-1], (r[0], r[1], r[0] + r[2], r[1] + r[3]))
                draw_dense_landmarks(out, pts, copy=False)          # out is ours
        return out

    return annotate


def _kind(path: str, flag: str) -> str:
    low = path.lower()
    if low.endswith(".png"):
        return "png"
    if low.endswith(".y4m"):
        return "y4m"
    raise SystemExit(f"{flag} {path!r}: the port reads and writes PNG images and YUV4MPEG2 "
                     "(.y4m) videos only; other image and video containers wait for a "
                     "codec (ROADMAP.md §1 item 2)")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="annotate detections on image/video")
    ap.add_argument("--input", required=True, help="a .png image or a .y4m video")
    ap.add_argument("--output", required=True, help="a .png (for an image) or .y4m (a video)")
    ap.add_argument("--conf", type=float, default=0.6)
    ap.add_argument("--det_size", type=int, default=320)
    ap.add_argument("--track", action="store_true",
                    help="run ByteTrack and color boxes per id")
    ap.add_argument("--dense_landmarks", action="store_true",
                    help="overlay the 478-pt dense landmarker per face")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--det_model", default=None,
                    help="YuNet ONNX file (default: models/yunet.py DEFAULT_MODEL)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the detector and the landmarker (default: the card)")
    args = ap.parse_args(argv)

    kind_in, kind_out = _kind(args.input, "--input"), _kind(args.output, "--output")
    if kind_in != kind_out:
        raise SystemExit(f"--output {args.output!r}: an annotated {kind_in} is written as "
                         f".{kind_in}")

    import torch

    from ..config import DetectorConfig
    from ..models.yunet import DEFAULT_MODEL, YuNet, detect_scaled
    from ..utils.image_io import imread, imwrite
    from ..utils.misc import check_device
    from ..utils.video_io import Y4mWriter, parse_header, read_y4m

    device = check_device(args.device, "viz")
    path = args.det_model or DEFAULT_MODEL
    if not os.path.isfile(path):
        raise SystemExit(f"viz: YuNet's ONNX file {path} does not exist; pass --det_model PATH")
    # the detector's float32 convolutions without TF32, as the app runs them
    torch.backends.cudnn.allow_tf32 = False
    det = YuNet(path, DetectorConfig(conf_threshold=args.conf), device=device)
    lm = None
    if args.dense_landmarks:
        from ..models.facemesh import DenseLandmarker

        lm = DenseLandmarker.pretrained(device=device)
    tracker = None
    if args.track:
        from ..track.byte_tracker import ByteTracker

        tracker = ByteTracker(track_thresh=0.5, match_thresh=0.8,
                              track_buffer=30, split_low_scores=False)
    annotate = make_annotator(lambda f: detect_scaled(det, f, args.det_size), tracker, lm)

    if kind_in == "png":                                        # single image
        imwrite(args.output, annotate(imread(args.input)))
        print(f"annotated image → {args.output}")
        return 0

    with open(args.input, "rb") as f:
        rate = parse_header(f.readline(), args.input).get("F", "25:1")
    num, _, den = rate.partition(":")
    fps = max(1, round(int(num) / int(den or 1))) if int(num) else 25
    n = 0
    with Y4mWriter(args.output, fps=fps) as vw:
        for frame in read_y4m(args.input, args.max_frames):
            vw.write(annotate(frame))
            n += 1
    print(f"annotated {n} frames → {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
