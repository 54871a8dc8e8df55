"""Dataset-production pipeline: videos → per-track face clips with AUs and
landmarks, on the card.

Own copy of ``stdd_tpu/data/preprocess.py`` (the reference's
``preprocessing/preprocessing_parallel.py``): per frame — detection +
ByteTrack, face crops, AU extraction batched every other frame with
last-known-value fill, sliding clip buffers (CLIP_LENGTH 8 / CLIP_STEP 4),
an async writer thread, resume-skip of processed videos and a per-video
timing log. The landmarker is a pluggable ``(frame_rgb, box_tlbr) ->
[N, 2]`` callable (the packaged dense landmarker by default), checked per
frame against the detector's 5 points by the landmark-quality sentinel.

Differences from the JAX package:
- video files are YUV4MPEG2 (``.y4m``, ``utils/video_io.py``); the port has
  no decoder for other containers, and a video of another container in the
  tree raises a ``ValueError`` naming it instead of being skipped;
- the crop resize is cv2's INTER_LINEAR sample grid in float32
  (``models/yunet.py::resize_linear_u8``), at most one grey level from
  ``cv2.resize``, and the ``--aligned`` warp is
  ``ops/align.py::warp_affine_u8``;
- the detector, the AU model and the landmarker run on the card unless the
  CLI gets ``--device cpu``; decoding, cropping, the sentinel and the
  writer stay on the host, as in JAX.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.facemesh import LM5_AGREEMENT_BOUND, LM5_DENSE_IDX, lm5_agreement
from ..models.yunet import resize_linear_u8
from ..ops.align import align_clip_host
from ..runtime.engine import get_crop_box
from ..track.byte_tracker import ByteTracker
from ..utils.video_io import read_y4m

CLIP_LENGTH = 8
CLIP_STEP = 4
CLIP_SIZE = (224, 224)
VIDEO_EXTS = (".y4m", ".mp4", ".avi", ".mov", ".mkv")


@dataclass
class ClipTask:
    video_rel: str
    track_id: int
    clip_idx: int
    images: np.ndarray                 # [T, H, W, 3] uint8 RGB
    landmarks: List[Optional[np.ndarray]]
    aus: List[Dict[str, float]]
    frame_start: int
    frame_end: int
    frame_ids: Optional[List[int]] = None  # per-frame source indices
    # landmark-quality sentinel: mean box-relative dense-vs-detector-lm5
    # agreement over the clip's frames (nan when no detector landmarks were
    # available), and whether the track had been flagged
    lm5_agreement: float = float("nan")
    lm_flagged: bool = False


class ClipWriter:
    """Async writer thread: clips go to
    ``out/<video_rel>/track_<id>/clip_<idx:05d>/{images,landmarks,aus}.npy``
    (and ``frame_ids.npy``), plus a ``master_clip_log.csv`` row each. A
    failed write is kept in ``errors`` and warned about loudly on
    :meth:`close`."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.q: "queue.Queue[Optional[ClipTask]]" = queue.Queue()
        self.rows: List[List] = []
        self.errors: List[str] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, task: ClipTask) -> None:
        self.q.put(task)

    def close(self) -> None:
        self.q.put(None)
        self._thread.join()
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "master_clip_log.csv"), "a", newline="") as f:
            w = csv.writer(f)
            if f.tell() == 0:
                w.writerow(["video", "track_id", "clip_idx", "frame_start",
                            "frame_end", "n_frames", "path",
                            "lm5_agreement", "lm_flagged"])
            w.writerows(self.rows)
        if self.errors:
            # a long production run on a full disk must not report success
            # with clips missing
            head = "; ".join(self.errors[:5])
            warnings.warn(
                f"ClipWriter: {len(self.errors)} clip write(s) FAILED "
                f"(first: {head}) — see writer.errors", RuntimeWarning,
            )

    def _run(self) -> None:
        while True:
            task = self.q.get()
            if task is None:
                return
            try:
                d = os.path.join(self.out_dir, task.video_rel, f"track_{task.track_id}",
                                 f"clip_{task.clip_idx:05d}")
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, "images.npy"), task.images)
                np.save(os.path.join(d, "landmarks.npy"),
                        np.asarray(task.landmarks, dtype=object), allow_pickle=True)
                np.save(os.path.join(d, "aus.npy"),
                        np.asarray(task.aus, dtype=object), allow_pickle=True)
                if task.frame_ids is not None:
                    # exact per-frame source indices: window stitching can
                    # dedupe the CLIP_STEP overlap even across gapped clips
                    np.save(os.path.join(d, "frame_ids.npy"),
                            np.asarray(task.frame_ids, np.int64))
                self.rows.append([
                    task.video_rel, task.track_id, task.clip_idx,
                    task.frame_start, task.frame_end, len(task.images), d,
                    round(task.lm5_agreement, 4), task.lm_flagged,
                ])
            except Exception as e:  # keep draining
                self.errors.append(f"{task.video_rel}/track_{task.track_id}: {e}")


class PreprocessPipeline:
    def __init__(
        self,
        detect_fn: Callable[[np.ndarray], np.ndarray],   # BGR frame → [N,15] rows
        au_extractor=None,                                # AUExtractor or None
        landmarker: Optional[Callable] = None,            # (frame_rgb, tlbr) → [N,2]
        clip_length: int = CLIP_LENGTH,
        clip_step: int = CLIP_STEP,
        crop_size: Tuple[int, int] = CLIP_SIZE,           # (w, h), as cv2.resize's dsize
        au_every: int = 2,                                # AU cadence (reference: every other frame)
        track_kwargs: Optional[dict] = None,
        lm_sentinel: bool = True,
        aligned: bool = False,
        crop_scale: float = 0.5,
    ):
        self.detect_fn = detect_fn
        self.au_extractor = au_extractor
        self.landmarker = landmarker
        self.clip_length = clip_length
        self.clip_step = clip_step
        self.crop_size = crop_size
        self.au_every = au_every
        # aligned: write clip-stable warp-aligned big-box crops (ONE
        # similarity per clip from the detector's 5-pt landmarks, the
        # geometry the serving scorer feeds the model) instead of plain
        # resized detector-box crops
        self.aligned = aligned
        self.crop_scale = crop_scale
        # landmark-quality sentinel: a track whose rolling disagreement with
        # the detector's 5 points exceeds LM5_AGREEMENT_BOUND is flagged and
        # its dense landmarks are dropped from then on
        self.lm_sentinel = lm_sentinel
        self.track_kwargs = track_kwargs or dict(
            track_thresh=0.5, match_thresh=0.8, track_buffer=30,
            split_low_scores=False,
        )

    def process_video(
        self, video_path: str, writer: ClipWriter, video_rel: Optional[str] = None,
        max_frames: Optional[int] = None,
    ) -> Dict[str, float]:
        """Run one ``.y4m`` video through the pipeline; returns its ``perf``
        dict (frames, clips and the seconds of detection, AU, landmarks and
        the whole video)."""
        if not video_path.lower().endswith(".y4m"):
            raise ValueError(f"{video_path}: the port has no decoder for this container; "
                             "convert it to YUV4MPEG2 (.y4m) first (ROADMAP item 2)")
        return self.process_frames(read_y4m(video_path, max_frames or None), writer,
                                   video_rel or os.path.splitext(os.path.basename(video_path))[0])

    def process_frames(self, frames, writer: ClipWriter, video_rel: str) -> Dict[str, float]:
        """The per-frame loop over an iterable of BGR uint8 frames."""
        self._fid_buf: Dict[int, List[int]] = {}
        # sentinel state: rolling agreement window, per-frame values aligned
        # with img_buf (nan = no detector lm that frame), and flagged tids
        self._agree_roll: Dict[int, List[float]] = {}
        self._agr_buf: Dict[int, List[float]] = {}
        self._lm_flagged: set = set()
        self._align_buf: Dict[int, List] = {}   # aligned mode: (crop, box, lm5)
        tracker = ByteTracker(**self.track_kwargs)
        img_buf: Dict[int, List[np.ndarray]] = {}
        au_buf: Dict[int, List[Optional[Dict]]] = {}
        lm_buf: Dict[int, List[Optional[np.ndarray]]] = {}
        last_known: Dict[int, Dict] = {}
        counters: Dict[int, int] = {}
        perf = {"frames": 0, "clips": 0, "t_detect": 0.0, "t_au": 0.0,
                "t_landmark": 0.0, "t_total": 0.0}

        t_start = time.perf_counter()
        frame_id = 0
        for frame in frames:
            self._step(frame, frame_id, tracker, writer, video_rel,
                       img_buf, au_buf, lm_buf, last_known, counters, perf)
            frame_id += 1
        perf["frames"] = frame_id
        perf["t_total"] = time.perf_counter() - t_start
        perf["clips"] = sum(counters.values())
        return perf

    # -- per-frame ------------------------------------------------------------

    def _step(self, frame_bgr, frame_id, tracker, writer, video_rel,
              img_buf, au_buf, lm_buf, last_known, counters, perf) -> None:
        t0 = time.perf_counter()
        rows = np.asarray(self.detect_fn(frame_bgr))
        perf["t_detect"] += time.perf_counter() - t0
        tlbr = (
            np.stack([rows[:, 0], rows[:, 1], rows[:, 0] + rows[:, 2],
                      rows[:, 1] + rows[:, 3], rows[:, 14]], axis=1)
            if rows.size else np.empty((0, 5))
        )
        live = tracker.update(tlbr)
        frame_rgb = frame_bgr[:, :, ::-1]
        H, W = frame_bgr.shape[:2]

        faces, tids, aligns = [], [], []
        for tr in live:
            x1, y1, x2, y2 = np.clip(
                np.rint(tr.tlbr).astype(int), [0, 0, 0, 0], [W - 1, H - 1, W - 1, H - 1]
            )
            if x2 <= x1 + 1 or y2 <= y1 + 1:
                continue
            align = None
            if self.aligned:
                # aligned clips need the detector's 5-pt landmarks; a frame
                # whose track matched no detection row contributes nothing
                row = _match_detection_row(rows, tr.tlbr)
                if row is None:
                    continue
                big = get_crop_box((H, W), np.asarray(tr.tlbr[:4], np.float32),
                                   scale=self.crop_scale)
                bx1, by1, bx2, by2 = [int(v) for v in big]
                align = (np.ascontiguousarray(frame_rgb[by1:by2, bx1:bx2]),
                         np.asarray(big, np.float32),
                         row[4:14].reshape(5, 2).astype(np.float32)
                         - np.array([bx1, by1], np.float32))
            crop = np.ascontiguousarray(frame_rgb[y1:y2, x1:x2])     # cv2.resize(crop, crop_size)
            faces.append(resize_linear_u8(torch.from_numpy(crop), self.crop_size[1],
                                          self.crop_size[0]).numpy())
            tids.append(tr.track_id)
            aligns.append(align)

        # AU extraction: batched, every au_every frames; last-known fill
        aus_now: Dict[int, Optional[Dict]] = {t: None for t in tids}
        if faces and self.au_extractor is not None and frame_id % self.au_every == 0:
            t0 = time.perf_counter()
            dicts = self.au_extractor(np.stack(faces))
            perf["t_au"] += time.perf_counter() - t0
            aus_now = dict(zip(tids, dicts))

        # landmarks (pluggable)
        lms_now: Dict[int, Optional[np.ndarray]] = {t: None for t in tids}
        if self.landmarker is not None:
            t0 = time.perf_counter()
            for tr in live:
                # lms_now is keyed by the tracks with a usable box
                if tr.track_id in lms_now and tr.track_id not in self._lm_flagged:
                    lm = self.landmarker(frame_rgb, tr.tlbr)
                    if lm is not None:
                        lms_now[tr.track_id] = np.asarray(lm, np.float32)
            perf["t_landmark"] += time.perf_counter() - t0

        # landmark-quality sentinel: the detector's 5 points referee the
        # dense landmarker; a flagged track's dense landmarks are dropped
        agr_now: Dict[int, float] = {}
        if self.landmarker is not None and self.lm_sentinel:
            for tr in live:
                tid = tr.track_id
                pts = lms_now.get(tid)
                if pts is None or pts.shape[0] <= max(LM5_DENSE_IDX):
                    continue
                row = _match_detection_row(rows, tr.tlbr)
                if row is None:
                    continue
                a = lm5_agreement(pts, row[4:14].reshape(5, 2), row[2])
                agr_now[tid] = a
                roll = self._agree_roll.setdefault(tid, [])
                roll.append(a)
                del roll[:-30]
                if len(roll) >= 3 and float(np.mean(roll)) > LM5_AGREEMENT_BOUND:
                    self._lm_flagged.add(tid)
            for tid in self._lm_flagged:
                if lms_now.get(tid) is not None:
                    lms_now[tid] = None

        for crop, tid, align in zip(faces, tids, aligns):
            img_buf.setdefault(tid, [])
            au_buf.setdefault(tid, [])
            lm_buf.setdefault(tid, [])
            if self.aligned:
                self._align_buf.setdefault(tid, []).append(align)
            fid_buf = self._fid_buf.setdefault(tid, [])
            fid_buf.append(frame_id)
            lk = last_known.setdefault(tid, {"aus": None, "lm": None})
            if aus_now.get(tid) is not None:
                lk["aus"] = aus_now[tid]
            if lms_now.get(tid) is not None:
                lk["lm"] = lms_now[tid]
            if tid in self._lm_flagged:
                # flagged: the last-known fill goes too, so stale points
                # cannot keep passing the clip completeness gate
                lk["lm"] = None
            img_buf[tid].append(crop)
            au_buf[tid].append(lk["aus"])
            lm_buf[tid].append(lk["lm"])
            self._agr_buf.setdefault(tid, []).append(agr_now.get(tid, float("nan")))

            if len(img_buf[tid]) >= self.clip_length:
                aus = [a for a in au_buf[tid][: self.clip_length] if a is not None]
                lms = [l for l in lm_buf[tid][: self.clip_length] if l is not None]
                au_ok = self.au_extractor is None or len(aus) >= self.clip_length
                # a flagged track still writes its clips, with the landmarks
                # nulled: the sentinel distrusts the landmarker, not the face
                flagged = tid in self._lm_flagged
                lm_ok = (self.landmarker is None or flagged
                         or len(lms) >= self.clip_length)
                if au_ok and lm_ok:
                    idx = counters.setdefault(tid, 0)
                    fids = self._fid_buf[tid][: self.clip_length]
                    agr = np.asarray(self._agr_buf[tid][: self.clip_length], np.float64)
                    agr_mean = (float(np.nanmean(agr))
                                if np.isfinite(agr).any() else float("nan"))
                    if self.aligned:
                        ab = self._align_buf[tid][: self.clip_length]
                        images = align_clip_host(
                            [a[0] for a in ab],
                            np.stack([a[1] for a in ab]),
                            np.stack([a[2] for a in ab]),
                            out_size=self.crop_size[0])
                    else:
                        images = np.stack(img_buf[tid][: self.clip_length])
                    writer.submit(ClipTask(
                        video_rel, tid, idx,
                        images,
                        ([None] * self.clip_length if flagged
                         else lm_buf[tid][: self.clip_length]),
                        au_buf[tid][: self.clip_length],
                        fids[0], fids[-1],   # true (possibly gapped) frame span
                        frame_ids=list(fids),
                        lm5_agreement=agr_mean,
                        lm_flagged=tid in self._lm_flagged,
                    ))
                    counters[tid] = idx + 1
                img_buf[tid] = img_buf[tid][self.clip_step:]
                au_buf[tid] = au_buf[tid][self.clip_step:]
                lm_buf[tid] = lm_buf[tid][self.clip_step:]
                self._fid_buf[tid] = self._fid_buf[tid][self.clip_step:]
                self._agr_buf[tid] = self._agr_buf[tid][self.clip_step:]
                if self.aligned:
                    self._align_buf[tid] = self._align_buf[tid][self.clip_step:]


def _match_detection_row(rows: np.ndarray, tlbr) -> Optional[np.ndarray]:
    """Best-IoU detection row for a track box (IoU > 0.5 required): pairs
    the tracker's box with the detector's landmarks."""
    if rows.size == 0:
        return None
    x1, y1, x2, y2 = [float(v) for v in tlbr[:4]]
    rx1, ry1 = rows[:, 0], rows[:, 1]
    rx2, ry2 = rows[:, 0] + rows[:, 2], rows[:, 1] + rows[:, 3]
    iw = np.maximum(0.0, np.minimum(x2, rx2) - np.maximum(x1, rx1))
    ih = np.maximum(0.0, np.minimum(y2, ry2) - np.maximum(y1, ry1))
    inter = iw * ih
    union = (x2 - x1) * (y2 - y1) + rows[:, 2] * rows[:, 3] - inter
    iou = inter / np.maximum(union, 1e-9)
    j = int(np.argmax(iou))
    return rows[j] if iou[j] > 0.5 else None


def already_processed(out_dir: str, video_rel: str) -> bool:
    """Resume-skip: a video with existing track_* dirs is done."""
    base = os.path.join(out_dir, video_rel)
    if not os.path.isdir(base):
        return False
    return any(d.startswith("track_") for d in os.listdir(base))


def process_tree(
    pipeline: PreprocessPipeline,
    video_root: str,
    out_dir: str,
    max_frames: Optional[int] = None,
    exts: Tuple[str, ...] = VIDEO_EXTS,
    detector_for: Optional[Callable[[str], Callable]] = None,
) -> List[Dict]:
    """Walk a video tree, skipping processed videos; write a perf CSV. A
    video whose extension is in ``exts`` but is not ``.y4m`` raises (the
    port decodes only YUV4MPEG2). ``detector_for(path)``, when given, makes
    each video's ``detect_fn`` (a detector that knows its video, such as a
    rendered scene's oracle)."""
    writer = ClipWriter(out_dir)
    logs: List[Dict] = []
    try:
        for dirpath, _, files in os.walk(video_root):
            for fn in sorted(files):
                if not fn.lower().endswith(exts):
                    continue
                vp = os.path.join(dirpath, fn)
                rel = os.path.splitext(os.path.relpath(vp, video_root))[0]
                if already_processed(out_dir, rel):
                    continue
                if detector_for is not None:
                    pipeline.detect_fn = detector_for(vp)
                perf = pipeline.process_video(vp, writer, rel, max_frames)
                perf["video"] = rel
                logs.append(perf)
    finally:
        writer.close()
    if logs:
        with open(os.path.join(out_dir, "pipeline_performance_log.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(logs[0].keys()))
            w.writeheader()
            w.writerows(logs)
    return logs


def build_parser():
    """The dataset-production CLI's flags (the JAX CLI's, plus ``--device``)."""
    import argparse

    from ..models.yunet import DEFAULT_MODEL

    ap = argparse.ArgumentParser(description="videos (.y4m) → face-clip dataset")
    ap.add_argument("--video_root", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--clip_length", type=int, default=CLIP_LENGTH)
    ap.add_argument("--clip_step", type=int, default=CLIP_STEP)
    ap.add_argument("--au_ckpt", default=None,
                    help="LibreFace AU ResNet-18 torch checkpoint; 'random' "
                         "for random init; omit to skip AU extraction")
    ap.add_argument("--landmarker", default="dense",
                    help="'dense' (packaged checkpoint), 'none', or a .pkl path")
    ap.add_argument("--yunet_model", default=None,
                    help=f"YuNet ONNX file (default {DEFAULT_MODEL})")
    ap.add_argument("--det_conf", type=float, default=0.6)
    ap.add_argument("--det_size", type=int, default=320)
    ap.add_argument("--crop_size", type=int, default=CLIP_SIZE[0],
                    help="written crop side (square), default 224")
    ap.add_argument("--track_thresh", type=float, default=0.5,
                    help="ByteTrack high-score threshold (lower it for "
                         "low-confidence domains, e.g. rendered scenes)")
    ap.add_argument("--match_thresh", type=float, default=0.8)
    ap.add_argument("--features", action="store_true",
                    help="also convert the tree to lmk/au features + norm stats")
    ap.add_argument("--aligned", action="store_true",
                    help="write clip-stable warp-aligned big-box crops (the "
                         "serving scorer's geometry) instead of plain resized "
                         "detector-box crops")
    ap.add_argument("--crop_scale", type=float, default=0.5,
                    help="big-box expansion for --aligned (get_crop_box scale)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(args, device: torch.device, detector_for: Callable[[str], Callable]) -> List[Dict]:
    """The CLI's work for parsed ``args`` on ``device``, each video detected
    by ``detector_for(path)``: the AU model and landmarker the flags name,
    the pipeline, ``process_tree`` and, with ``--features``, the feature
    files and norm stats."""
    au = None
    if args.au_ckpt:
        from ..models.au_resnet import AUExtractor

        au = (AUExtractor.random_init(device=device) if args.au_ckpt == "random"
              else AUExtractor.from_torch_checkpoint(args.au_ckpt, device=device))

    lm = None
    if args.landmarker == "dense":
        from ..models.facemesh import DenseLandmarker

        lm = DenseLandmarker.pretrained(device=device)
    elif args.landmarker not in (None, "none"):
        from ..models.facemesh import DenseLandmarker

        lm = DenseLandmarker.from_checkpoint(args.landmarker, device=device)

    pipe = PreprocessPipeline(
        None, au_extractor=au, landmarker=lm,
        clip_length=args.clip_length, clip_step=args.clip_step,
        crop_size=(args.crop_size, args.crop_size),
        aligned=args.aligned, crop_scale=args.crop_scale,
        track_kwargs=dict(track_thresh=args.track_thresh,
                          match_thresh=args.match_thresh,
                          track_buffer=30, split_low_scores=False),
    )
    logs = process_tree(pipe, args.video_root, args.out_dir, max_frames=args.max_frames,
                        detector_for=detector_for)
    print(f"processed {len(logs)} videos, "
          f"{sum(l.get('clips', 0) for l in logs)} clips → {args.out_dir}")

    if args.features:
        from .features import compute_norm_stats, process_clip_tree

        stats = process_clip_tree(args.out_dir)
        out = compute_norm_stats(args.out_dir, os.path.join(args.out_dir, "norm_stats.npz"))
        print(f"features: {stats}; norm stats → {out}")
    return logs


def main(argv=None):
    """Dataset-production CLI: ``.y4m`` videos → per-track clips with
    images, landmarks and AUs, on the card (``--device cuda``, the default;
    it stops when there is none) or the CPU (``--device cpu``).

    ``--landmarker dense`` (default) wires the packaged dense landmarker;
    pass a ``.pkl`` path for another checkpoint or ``none`` to skip
    landmarks. ``--au_ckpt random`` runs random AU weights, a path loads a
    LibreFace checkpoint; omit it to skip AUs. ``--features`` converts the
    written tree to lmk/au feature files and norm stats in the same run."""
    from ..config import DetectorConfig
    from ..models.yunet import DEFAULT_MODEL, YuNet, detect_scaled

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("preprocess: --device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run on the CPU")
    model_path = args.yunet_model or DEFAULT_MODEL
    if not os.path.isfile(model_path):
        raise SystemExit(f"preprocess: YuNet's ONNX file {model_path} does not exist; "
                         "pass --yunet_model PATH")
    detector = YuNet(model_path, cfg=DetectorConfig(conf_threshold=args.det_conf),
                     device=device)

    def detect_fn(frame_bgr):
        return detect_scaled(detector, frame_bgr, args.det_size)

    return run(args, device, lambda path: detect_fn)


if __name__ == "__main__":
    main()
