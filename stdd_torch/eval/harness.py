"""Offline streaming-evaluation harness (the reference's TEST2.py), on the
card.

Port of ``stdd_tpu/eval/harness.py``. It runs the streaming engine over a
directory (or list file) of videos and writes the reference harness's two
CSV artifacts (schemas at TEST2.py:1071-1141):

- per_video.csv: one row per video with verdict, score, throughput, latency,
  track stats, memory;
- summary.csv: accuracy / ROC-AUC / PR-AUC / F1 / confusion matrix + mean
  fps / latency / model size.

What differs from the JAX module:

- Video files are YUV4MPEG2 (``.y4m``, ``utils/video_io.py``): the JAX
  harness decodes with ``cv2.VideoCapture``, which the port may not import.
  A collected video of another container raises, naming the decoder that
  is still missing (ROADMAP.md §1 item 2); it is never skipped. ``main``
  checks the whole list before it builds the scorer.
- :func:`summarize` computes its metrics in numpy (``train/metrics.py``),
  not with scikit-learn.
- ``--clip_size`` sets the frames the model takes also when a
  ``--jax_ckpt`` has a sidecar (ADVICE.md r5 #2; ``runtime/classifier.py::
  load_scorer``).
- ``--device`` picks the card (the default; the harness stops without one)
  or the CPU. ``--int8`` is refused by name (ROADMAP.md §1 item 9).

Usage:
    python -m stdd_torch.eval.harness --video_root DIR --ckpt CKPT.pth \\
        --out_dir eval_outputs [--pool_method mean --threshold 0.4 ...]
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..train.metrics import average_precision, roc_auc
from ..utils.misc import check_device
from ..utils.video_io import read_y4m

# Path-token labeling identical to the reference (demo.py:93-103)
REAL_TOK = ("/original/", "/original_sequences/", "/celeb-real/", "/youtube-real/", "/real/", "/source/")
FAKE_TOK = ("/target/", "/manipulated_sequences/", "/deepfakes/", "/face2face/",
            "/faceswap/", "/neuraltextures/", "/fake/", "/celeb-synthesis/")
DATASETS_HINT = ("ffpp", "ffiw", "celebdf_v2", "faceforensics++", "faceforensics", "celebdf")
SUBSETS_HINT = ("train", "val", "test", "c23", "c40")
VIDEO_EXTS = (".y4m", ".mp4", ".avi", ".mov", ".mkv")


def classify_path(p: str) -> Optional[int]:
    pl = "/" + p.replace("\\", "/").lower().strip("/") + "/"
    if any(t in pl for t in REAL_TOK):
        return 0
    if any(t in pl for t in FAKE_TOK):
        return 1
    return None


def dataset_of(p: str) -> str:
    pl = p.replace("\\", "/").lower()
    for s in DATASETS_HINT:
        if s in pl:
            return s
    if any(x in pl for x in ("deepfakes", "face2face", "faceswap", "neuraltextures",
                             "original", "original_sequences")):
        return "ffpp"
    return "unknown"


def subset_of(p: str) -> str:
    pl = p.replace("\\", "/").lower()
    for s in SUBSETS_HINT:
        if f"/{s}/" in pl or pl.endswith(f"/{s}"):
            return s
    return "unknown"


def collect_videos(
    root: str, per_class: int = 500, seed: int = 0
) -> List[Tuple[str, int, str, str]]:
    """(path, label, dataset, subset) tuples, balanced per class
    (demo.py:90 collect_videos)."""
    pool_real, pool_fake = [], []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.lower().endswith(VIDEO_EXTS):
                continue
            p = os.path.join(dirpath, fn)
            lab = classify_path(p)
            if lab == 0:
                pool_real.append(p)
            elif lab == 1:
                pool_fake.append(p)
    rng = random.Random(seed)
    rng.shuffle(pool_real)
    rng.shuffle(pool_fake)
    out = [
        (p, 0, dataset_of(p), subset_of(p)) for p in pool_real[:per_class]
    ] + [(p, 1, dataset_of(p), subset_of(p)) for p in pool_fake[:per_class]]
    rng.shuffle(out)
    return out


def collect_from_list(list_path: str) -> List[Tuple[str, int, str, str]]:
    """'path[,label]' per line; label inferred from path when absent
    (TEST2.py:923-949)."""
    out = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "," in line:
                p, lab = line.rsplit(",", 1)
                lab = int(lab)
            else:
                p = line
                lab = classify_path(p)
                if lab is None:
                    continue
            out.append((p, lab, dataset_of(p), subset_of(p)))
    return out


def check_decodable(paths: Sequence[str]) -> None:
    """Raise once, naming every path that is not a ``.y4m``: the port has no
    decoder for other containers yet (ROADMAP.md §1 item 2). The CLIs call
    this before they build a scorer, so a mixed tree fails before any video
    is scored rather than after hours of scoring."""
    bad = [p for p in paths if not p.lower().endswith(".y4m")]
    if bad:
        raise ValueError(f"{len(bad)} video(s) of a container the port cannot decode yet "
                         f"(ROADMAP.md §1 item 2); convert them to YUV4MPEG2 (.y4m) "
                         f"first: {', '.join(bad)}")


def iter_video_frames(path: str, max_frames: Optional[int] = None):
    """BGR uint8 frames of a ``.y4m`` video, at most ``max_frames``. Another
    container raises: its decoder is not ported (ROADMAP.md §1 item 2)."""
    check_decodable([path])
    return read_y4m(path, max_frames)


def device_mem_peak_mb(device) -> float:
    """Peak device memory allocated by PyTorch on ``device``, in MB (the
    reference reads ``torch.cuda.max_memory_allocated``, TEST2.py:321); NaN
    on the CPU, which has no such count."""
    device = torch.device(device)
    if device.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def run_video(engine, video_path: str, threshold: float, max_frames=None, **agg) -> Dict:
    """Stream one video through the engine; mirrors VideoRunner.run outputs."""
    engine.reset()
    t0 = time.perf_counter()
    frames = 0
    for frame in iter_video_frames(video_path, max_frames):
        engine.step(frame)
        frames += 1
    verdict = engine.finish(threshold=threshold, **agg)
    elapsed = time.perf_counter() - t0
    lat_ms = (
        1000.0 * float(np.mean(engine.clip_latencies))
        if engine.clip_latencies
        else float("nan")
    )
    return {
        "video_path": video_path,
        "frames_processed": frames,
        "elapsed_s": elapsed,
        "fps": frames / max(elapsed, 1e-6),
        "latency_ms_clip_mean": lat_ms,
        "num_tracks": len(engine.track_clip_scores),
        "id_switch_rate": 1000.0 * engine.id_switches / max(frames, 1),
        "pred_label": int(verdict.video_fake),
        "video_score": float(verdict.video_score),
        "per_person_labels": verdict.per_person_labels,
        "low_quality": verdict.low_quality,
    }


def summarize(rows: List[Dict], model_size: int) -> Dict:
    """Accuracy, ROC-AUC, AP, F1 and the confusion matrix (labels 0, 1) as
    scikit-learn's ``accuracy_score``, ``roc_auc_score``,
    ``average_precision_score``, ``f1_score`` (0 where undefined) and
    ``confusion_matrix`` give them; AUC and AP are NaN with one class."""
    y_true = np.asarray([r["gt_label"] for r in rows], np.int64)
    y_pred = np.asarray([r["pred_label"] for r in rows], np.int64)
    y_score = np.asarray([r["video_score"] for r in rows], np.float64)
    if len(y_true) and len(set(y_true.tolist())) > 1:
        auc = roc_auc(y_true, y_score)
        ap = average_precision(y_true, y_score)
    else:
        auc = ap = float("nan")
    if len(y_true):
        cm = np.array([[np.sum((y_true == t) & (y_pred == p)) for p in (0, 1)]
                       for t in (0, 1)])
        (tn, fp), (fn, tp) = cm
        acc = float(np.mean(y_true == y_pred))
        f1 = float(2 * tp / (2 * tp + fp + fn)) if tp + fp + fn else 0.0
    else:
        cm = np.zeros((2, 2))
        tn = fp = fn = tp = 0
        acc = f1 = float("nan")
    warm = [r for r in rows if not r.get("cold_start")]
    return {
        "videos": len(rows),
        "accuracy": acc,
        "auc_roc": auc,
        "pr_auc": ap,
        "f1": f1,
        "tp": int(tp),
        "tn": int(tn),
        "fp": int(fp),
        "fn": int(fn),
        "confusion_matrix": cm.tolist(),
        # a cold row (the first video of a run without warm-up) holds the
        # first-call costs: it is left out of the throughput means
        "mean_fps": float(np.nanmean([r["fps"] for r in warm])) if warm else float("nan"),
        "mean_latency_ms_clip": float(np.nanmean([r["latency_ms_clip_mean"] for r in warm]))
        if warm else float("nan"),
        "model_size": model_size,
    }


PER_VIDEO_HEADER = [
    "video_path", "dataset", "subset", "gt_label", "pred_label", "correct",
    "video_score", "threshold",
    "frames_processed", "elapsed_s", "fps", "latency_ms_clip_mean",
    "num_tracks", "id_switch_rate_per_1k_frames",
    "device_mem_peak_mb", "cpu_mem_peak_mb", "model_size", "cold_start",
]

SUMMARY_HEADER = [
    "videos", "accuracy", "auc_roc", "pr_auc", "f1",
    "tp", "tn", "fp", "fn", "confusion_matrix", "mean_fps",
    "mean_latency_ms_clip", "model_size",
]


def write_csvs(rows: List[Dict], summary: Dict, out_dir: str, threshold: float) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "per_video.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(PER_VIDEO_HEADER)
        for r in rows:
            w.writerow([
                r["video_path"], r["dataset"], r["subset"], r["gt_label"],
                r["pred_label"], int(r["pred_label"] == r["gt_label"]),
                f"{r['video_score']:.6f}", threshold,
                r["frames_processed"], f"{r['elapsed_s']:.3f}",
                f"{r['fps']:.3f}", f"{r['latency_ms_clip_mean']:.3f}",
                r["num_tracks"], f"{r.get('id_switch_rate', 0.0):.3f}",
                f"{r.get('device_mem_peak_mb', float('nan')):.1f}",
                f"{r.get('cpu_mem_peak_mb', float('nan')):.1f}",
                r.get("model_size", 0),
                int(bool(r.get("cold_start"))),
            ])
    with open(os.path.join(out_dir, "summary.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(SUMMARY_HEADER)
        w.writerow([
            summary["videos"],
            f"{summary['accuracy']:.6f}" if not math.isnan(summary["accuracy"]) else "nan",
            f"{summary['auc_roc']:.6f}" if not math.isnan(summary["auc_roc"]) else "nan",
            f"{summary['pr_auc']:.6f}" if not math.isnan(summary["pr_auc"]) else "nan",
            f"{summary['f1']:.6f}" if not math.isnan(summary["f1"]) else "nan",
            summary["tp"], summary["tn"], summary["fp"], summary["fn"],
            json.dumps(summary["confusion_matrix"]),
            f"{summary['mean_fps']:.3f}",
            f"{summary['mean_latency_ms_clip']:.3f}",
            summary["model_size"],
        ])


def yunet_detector(model_path: Optional[str], device, conf: float, top_k: int, who: str):
    """The port's YuNet over ``model_path`` (default: the packaged file),
    stopping with the path when the file is absent."""
    from ..config import DetectorConfig
    from ..models.yunet import DEFAULT_MODEL, YuNet

    path = model_path or DEFAULT_MODEL
    if not os.path.isfile(path):
        raise SystemExit(f"{who}: YuNet's ONNX file {path} does not exist; "
                         "pass --yunet_model PATH")
    return YuNet(path, DetectorConfig(conf_threshold=conf, top_k=top_k), device=device)


def build_engine(args, detect_fn=None):
    """(engine, warmed): the scorer of ``--ckpt`` / ``--jax_ckpt`` (random
    weights with neither), YuNet over ``--yunet_model`` through
    ``detect_scaled`` (or the caller's ``detect_fn``), and the streaming
    engine at the CLI's settings, on ``--device``; warmed up on the card."""
    from ..config import PipelineConfig
    from ..models.yunet import detect_scaled
    from ..runtime.classifier import load_scorer
    from ..runtime.engine import StreamingEngine

    device = check_device(args.device, "harness")
    cfg = PipelineConfig(
        clip_size=args.clip_size,
        stride=args.stride,
        detect_every=args.detect_every,
        batch_clips=args.batch_clips,
        threshold=args.threshold,
        pool_method=args.pool_method,
        min_face_side=args.min_det_side,
        crop_scale=args.crop_scale,
    )
    scorer = load_scorer(args.ckpt, args.jax_ckpt, args.clip_size, args.model_crop,
                         upload_format=args.upload_format, device=device)
    if detect_fn is None:
        detector = yunet_detector(args.yunet_model, device, args.det_conf, args.det_topk,
                                  "harness")

        def detect_fn(frame_bgr):
            return detect_scaled(detector, frame_bgr, args.det_size)

    qkw = {}
    if not args.quality:
        # disable the blur/size quality gate — e.g. rendered or synthetic
        # scenes whose Laplacian statistics differ from camera footage
        qkw = dict(q_weighting=False, q_lap_hard=0.0)
    if args.track_thresh is not None:
        qkw["track_kwargs"] = dict(track_thresh=args.track_thresh,
                                   match_thresh=0.8, track_buffer=30,
                                   split_low_scores=False)
    engine = StreamingEngine(
        scorer, detect_fn, cfg=cfg, crop_buffer=args.crop_buffer,
        start_conf=args.det_conf, **qkw,
    )
    warmed = args.warmup and device.type == "cuda"
    if warmed:
        # run every batch capacity once, so the first video's fps does not
        # hold K1's build and cuDNN's algorithm choice
        engine.warmup()
    return engine, warmed


def score_videos(engine, videos, args, warmed: bool, model_size: int,
                 before_video=None) -> List[Dict]:
    """``run_video`` over ``videos`` ((path, label, dataset, subset) each)
    at ``args``' threshold and frame cap, one row a video with its labels,
    peak device memory and model size; ``before_video(path)`` is called
    before each video."""
    rows = []
    for vpath, gt, dset, subset in videos:
        if before_video is not None:
            before_video(vpath)
        res = run_video(engine, vpath, args.threshold, args.max_frames)
        res.update(
            gt_label=gt, dataset=dset, subset=subset,
            device_mem_peak_mb=device_mem_peak_mb(engine.scorer.device),
            model_size=model_size,
            # without warm-up the first video's timings hold the
            # first-call costs; flag the row so summaries exclude it
            cold_start=(not warmed) and len(rows) == 0,
        )
        rows.append(res)
        print(
            f"[{len(rows)}/{len(videos)}] {os.path.basename(vpath)} gt={gt} "
            f"pred={res['pred_label']} score={res['video_score']:.4f} "
            f"fps={res['fps']:.1f}"
        )
    return rows


def build_parser() -> argparse.ArgumentParser:
    """The harness CLI's flags (the JAX CLI's, plus ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--video_root", default=None)
    ap.add_argument("--video_list", default=None)
    ap.add_argument("--out_dir", default="eval_outputs")
    ap.add_argument("--ckpt", default=None, help="reference .pth checkpoint (converted on load)")
    ap.add_argument("--jax_ckpt", default=None,
                    help="msgpack checkpoint trained by stdd_tpu.train.run_i3d "
                         "(or stdd_torch.train.run_i3d)")
    ap.add_argument("--model_crop", type=int, default=None,
                    help="crop size the --jax_ckpt was trained at (default: "
                         "the checkpoint's sidecar metadata, else 224)")
    ap.add_argument("--yunet_model", default=None,
                    help="YuNet ONNX file (default: models/yunet.py DEFAULT_MODEL)")
    ap.add_argument("--per_class", type=int, default=500)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--clip_size", type=int, default=32)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--detect_every", type=int, default=4)
    ap.add_argument("--batch_clips", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.4)
    ap.add_argument("--pool_method", default="mean")
    ap.add_argument("--crop_scale", type=float, default=0.5)
    ap.add_argument("--crop_buffer", type=int, default=256)
    ap.add_argument("--det_conf", type=float, default=0.6)
    ap.add_argument("--det_size", type=int, default=320)
    ap.add_argument("--det_topk", type=int, default=64)
    ap.add_argument("--min_det_side", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--upload_format", default="rgb", choices=["rgb", "yuv420"],
                    help="crop upload format; yuv420 halves host->device bytes")
    ap.add_argument("--int8", action="store_true",
                    help="not ported: the int8 serving knob (ROADMAP.md §1 item 9)")
    ap.add_argument("--no_warmup", dest="warmup", action="store_false",
                    help="skip the startup run of every scorer batch shape")
    ap.add_argument("--no_quality", dest="quality", action="store_false",
                    help="disable blur/size quality gating (synthetic scenes)")
    ap.add_argument("--track_thresh", type=float, default=None,
                    help="override ByteTrack high-score threshold")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.int8:
        raise SystemExit("--int8 is not ported yet: it waits for the int8 serving knob "
                         "(ROADMAP.md §1 item 9)")
    if args.video_list:
        videos = collect_from_list(args.video_list)
    elif args.video_root:
        videos = collect_videos(args.video_root, args.per_class, args.seed)
    else:
        ap.error("need --video_root or --video_list")
    check_decodable([v[0] for v in videos])

    # the detector's float32 convolutions without TF32, as the app runs them
    torch.backends.cudnn.allow_tf32 = False
    engine, warmed = build_engine(args)
    model_size = os.path.getsize(args.ckpt) if args.ckpt else 0

    try:
        rows = score_videos(engine, videos, args, warmed, model_size)
    finally:
        engine.close()   # release the dispatch lanes and the rings
    summary = summarize(rows, model_size)
    write_csvs(rows, summary, args.out_dir, args.threshold)
    print("Summary:", {k: summary[k] for k in ("videos", "accuracy", "auc_roc", "mean_fps")})


if __name__ == "__main__":
    main()
