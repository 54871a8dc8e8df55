"""Official-pipeline offline video evaluation (the reference's demo.py), on
the card.

Port of ``stdd_tpu/eval/demo.py``. Flow (demo.py:170
eval_video_demo_timed): detect all frames (or read a detection cache) →
IoU-greedy tracking (``track/greedy.py``: ``multiple_tracking``, else the
``find_longest`` segmentation) → sliding clip windows (stride 1, reflect
padding for short tracks, demo.py:275-302) → clip-stable align (K1) + I3D →
sigmoid → video score = mean over clips (demo.py:339).

Clips are scored in fixed-size batches through the port's scorer, packed on
the host (:func:`score_clips`) or, with ``dense=True``, sliced on the card
from one upload of each track (``ClipScorer.score_dense``).
Reference-format detection caches (``torch.save`` of ``(detect_res,
lm68s)``) are read by :func:`load_reference_cache`.

The CLI decodes ``.y4m`` videos only (``eval/harness.py::
iter_video_frames``); it runs on the card (``--device cuda``, the default,
dense there) or with ``--device cpu``; ``--clip_size`` sets the frames the
model takes (ADVICE.md r5 #2); ``--int8`` runs s3-s5 through the int8
convolutions.

CLI: ``python -m stdd_torch.eval.demo --video_root DIR [--ckpt CKPT]
--yunet_model YUNET.onnx``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..runtime.engine import get_crop_box
from ..track.greedy import find_longest, multiple_tracking


def load_reference_cache(path: str):
    """Read a reference detection cache: a tuple whose first two elements
    are per-frame face lists [(box, lm5, score)] and per-frame lm68 lists.
    The file is unpickled (``weights_only=False``, as the JAX reader does:
    the caches hold numpy arrays): load only caches you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    detect_res, lm68s = obj[0], obj[1]
    return detect_res, lm68s


def window_index_lists(T: int, clip_size: int):
    """Sliding stride-1 windows, or ONE reflect-padded window for short
    tracks (demo.py:275-302).

    Note the reference's quirk, replicated deliberately: the LEFT pad is the
    reversed interior truncated from its start (``base[1:T-1][::-1][:l]`` —
    frames near the track's END), not a true np.pad-style reflection of the
    start. Parity with the reference's scored windows wins over prettiness.
    """
    base = list(range(T))
    if T >= clip_size:
        return [base[s : s + clip_size] for s in range(T - clip_size + 1)]
    need = clip_size - T
    refl = base[1 : T - 1][::-1] if T > 2 else [base[0]] * need
    l = need // 2
    r = need - l
    if refl:
        left = (refl * ((l + len(refl) - 1) // len(refl) or 1))[:l]
        right = (refl * ((r + len(refl) - 1) // len(refl) or 1))[:r]
    else:
        left = [base[0]] * l
        right = [base[-1]] * r
    return [left + base + right]


def build_clips(
    detect_res: Sequence[Sequence],
    lm68s: Sequence[Sequence],
    frames: Sequence[np.ndarray],
    clip_size: int = 32,
    crop_scale: float = 0.5,
):
    """Tracking + clip assembly (demo.py:224-302). Returns a list of clips,
    each a list of per-frame entry dicts ready for the scorer."""
    clips = []
    for entries, _ in build_tracks(detect_res, lm68s, frames, clip_size, crop_scale):
        for w in window_index_lists(len(entries), clip_size):
            clips.append([entries[j] for j in w])
    return clips


def build_tracks(
    detect_res: Sequence[Sequence],
    lm68s: Sequence[Sequence],
    frames: Sequence[np.ndarray],
    clip_size: int = 32,
    crop_scale: float = 0.5,
):
    """Like build_clips but keeps track identity: → list of
    (entries, window_starts); tracks shorter than clip_size get
    starts=None (caller falls back to the reflect-padded packed path)."""
    shape = frames[0].shape[:2]
    merged = []
    for faces, faces_lm68 in zip(detect_res, lm68s):
        merged.append(
            [
                (np.asarray(box), np.asarray(lm5), np.asarray(lm68), float(score))
                for (box, lm5, score), lm68 in zip(faces, faces_lm68)
            ]
        )
    tracks = multiple_tracking(merged)
    tuples = [(0, len(merged))] * len(tracks)
    if not tracks:
        tuples, tracks = find_longest(merged)

    out = []
    for (start, end), track in zip(tuples, tracks):
        entries = []
        for face, fi in zip(track, range(start, end)):
            box, lm5, lm68 = face[0], face[1], face[2]
            big_box = get_crop_box(shape, box, scale=crop_scale)
            tl = big_box[:2][None, :]
            x1, y1, x2, y2 = big_box
            entries.append(dict(
                crop=frames[fi][y1:y2, x1:x2], big_box=big_box,
                lm5=(lm5 - tl).astype(np.float32),
                lm68=(lm68 - tl).astype(np.float32), frame_idx=fi,
            ))
        T = len(entries)
        starts = list(range(T - clip_size + 1)) if T >= clip_size else None
        if T:
            out.append((entries, starts))
    return out


def score_clips(scorer, clips, crop_buffer: int = 256, batch: int = 8) -> List[float]:
    """Batched align+score of demo clips through the scorer (packing shared
    with the streaming engine)."""
    from ..runtime.packing import pack_clip_batch, upload_format_of

    preds: List[float] = []
    T = len(clips[0]) if clips else 0
    for bstart in range(0, len(clips), batch):
        group = clips[bstart : bstart + batch]
        crops, boxes, lm5, valid = pack_clip_batch(
            group, batch, T, crop_buffer,
            yuv420=upload_format_of(scorer) == "yuv420",
        )
        probs = scorer.score(crops, boxes, lm5, valid)
        preds.extend(float(p) for p in probs[: len(group)])
    return preds


def eval_video(
    scorer,
    frames: Sequence[np.ndarray],
    detect_res=None,
    lm68s=None,
    detector=None,
    clip_size: int = 32,
    crop_scale: float = 0.5,
    crop_buffer: int = 256,
    batch: int = 8,
    threshold: float = 0.04,
    dense: bool = False,
) -> Dict:
    """One video through the demo pipeline; mirrors eval_video_demo_timed's
    outputs (video_score = mean over clip sigmoids, demo.py:339)."""
    t0 = time.perf_counter()
    if detect_res is None:
        if detector is None:
            raise ValueError("eval_video needs cached detections or a detector")
        detect_res, lm68s = detector(frames)
    t_detect = time.perf_counter() - t0

    t1 = time.perf_counter()
    if dense:
        # each track goes to the device once; its stride-1 windows are
        # sliced there (ClipScorer.score_dense). Short tracks (reflect
        # padding) go through the packed path on their own windows.
        from ..runtime.packing import pack_track, upload_format_of

        tracks = build_tracks(detect_res, lm68s, frames, clip_size, crop_scale)
        preds: List[float] = []
        n_clips = 0
        short_windows: List[List[Dict]] = []
        for entries, starts in tracks:
            if starts is None:
                short_windows.extend(
                    [entries[j] for j in w]
                    for w in window_index_lists(len(entries), clip_size)
                )
                continue
            fbuf, bbuf, lbuf = pack_track(
                entries, crop_buffer,
                yuv420=upload_format_of(scorer) == "yuv420",
            )
            preds.extend(float(p) for p in scorer.score_dense(
                fbuf, bbuf, lbuf, starts, batch=batch, clip_size=clip_size
            ))
            n_clips += len(starts)
        if short_windows:   # all short tracks share full batches
            preds.extend(score_clips(scorer, short_windows, crop_buffer, batch))
            n_clips += len(short_windows)
        clips = [None] * n_clips
    else:
        clips = build_clips(detect_res, lm68s, frames, clip_size, crop_scale)
        preds = score_clips(scorer, clips, crop_buffer, batch) if clips else []
    t_aligninfer = time.perf_counter() - t1

    video_score = float(np.mean(preds)) if preds else 0.0
    t_total = time.perf_counter() - t0
    return {
        "video_score": video_score,
        "pred_label": int(video_score > threshold),
        "frames": len(frames),
        "clips": len(clips),
        "preds": preds,
        "t_total": t_total,
        "t_detect": t_detect,
        "t_aligninfer": t_aligninfer,
        "fps_end2end": len(frames) / max(t_total, 1e-9),
        "fps_model": len(clips) / max(t_aligninfer, 1e-9),
    }


def cache_from_rows(rows_per_frame):
    """Per-frame YuNet rows ``(x, y, w, h, 5×(x, y), score)`` → (detections,
    lm68s) in the cache's layout, each face's 68 points a tile of its 5
    points' mean (the placeholder of ``stdd_tpu/eval/demo.py:260``: no
    68-point landmarker is ported)."""
    det_res, lm68s = [], []
    for rows in rows_per_frame:
        faces, lms = [], []
        for r in rows:
            box = np.array([r[0], r[1], r[0] + r[2], r[1] + r[3]])
            lm5 = r[4:14].reshape(5, 2)
            faces.append((box, lm5, float(r[14])))
            lms.append(np.tile(lm5.mean(0), (68, 1)))
        det_res.append(faces)
        lm68s.append(lms)
    return det_res, lm68s


def yunet_demo_detector(det, det_size: int = 320):
    """``frames`` (RGB) → (detections, lm68s): YuNet through
    ``detect_scaled`` on each frame, then :func:`cache_from_rows`."""
    from ..models.yunet import detect_scaled

    def detector(frames):
        return cache_from_rows(detect_scaled(det, np.ascontiguousarray(f[:, :, ::-1]), det_size)
                               for f in frames)

    return detector


def main(argv=None):
    from ..utils.misc import check_device
    from .harness import (check_decodable, collect_videos, iter_video_frames, summarize,
                          write_csvs, yunet_detector)
    from ..runtime.classifier import load_scorer

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--video_root", required=True)
    ap.add_argument("--ckpt", default=None, help="reference .pth checkpoint (converted on load)")
    ap.add_argument("--jax_ckpt", default=None,
                    help="msgpack checkpoint trained by stdd_tpu.train.run_i3d "
                         "(or stdd_torch.train.run_i3d)")
    ap.add_argument("--out_dir", default="demo_outputs")
    ap.add_argument("--per_class", type=int, default=500)
    ap.add_argument("--max_frame", type=int, default=768)
    ap.add_argument("--clip_size", type=int, default=32)
    ap.add_argument("--threshold", type=float, default=0.04)
    ap.add_argument("--cache_dir", default=None,
                    help="detection cache directory (accepted and not read, as in "
                         "the JAX demo)")
    ap.add_argument("--dense", default=None, action="store_true",
                    help="device-resident track buffers (default: on for the card)")
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
    ap.add_argument("--yunet_model", default=None,
                    help="YuNet ONNX file (default: models/yunet.py DEFAULT_MODEL)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = check_device(args.device, "demo")
    videos = collect_videos(args.video_root, args.per_class)
    check_decodable([v[0] for v in videos])
    scorer = load_scorer(args.ckpt, args.jax_ckpt, args.clip_size, args.model_crop,
                         arch=args.arch, upload_format=args.upload_format, device=device,
                         int8=args.int8)
    torch.backends.cudnn.allow_tf32 = False     # the detector's float32, as the app runs it
    detector = yunet_demo_detector(yunet_detector(args.yunet_model, device, 0.5, 128, "demo"))
    dense = args.dense if args.dense is not None else device.type == "cuda"
    rows = []
    for vpath, gt, dset, subset in videos:
        frames = [f[:, :, ::-1] for f in iter_video_frames(vpath, args.max_frame)]  # RGB
        res = eval_video(
            scorer, frames, detector=detector,
            clip_size=args.clip_size, threshold=args.threshold, dense=dense,
        )
        res.update(
            video_path=vpath, gt_label=gt, dataset=dset, subset=subset,
            frames_processed=res["frames"], elapsed_s=res["t_total"],
            fps=res["fps_end2end"], latency_ms_clip_mean=float("nan"),
            num_tracks=1, device_mem_peak_mb=float("nan"), model_size=0,
        )
        rows.append(res)
        print(f"{os.path.basename(vpath)} gt={gt} score={res['video_score']:.4f}")
    summary = summarize(rows, 0)
    write_csvs(rows, summary, args.out_dir, args.threshold)
    print("Summary:", {k: summary[k] for k in ("videos", "accuracy", "auc_roc")})


if __name__ == "__main__":
    main()
