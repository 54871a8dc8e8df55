"""End-to-end synthetic benchmark on the card: the analyst's whole workflow
on one self-contained, reproducible dataset.

    python -m stdd_torch.eval.synth_e2e [--smoke] [--dual] [--out DIR] [--device cpu]

Twin of ``scripts/run_synth_e2e.py`` (same flags, configs, phases and JSON
fields), composed of the port's modules:

1. **Render** paired videos with ``eval/bench_scene.BenchScene``: real is a
   procedural talking head, fake the same seed with its talking loop
   scrambled (an ``expr_order`` permutation, :func:`fake_order`), so the
   only cue that separates the classes is temporal. Videos are written as
   ``real/vid_XXX.y4m`` and ``fake/vid_XXX.y4m`` (JAX writes MJPG ``.avi``,
   which the port cannot decode: ROADMAP §1 item 2).
2. **Preprocess** with ``data/preprocess.py``'s pipeline and tree writer at
   the JAX CLI's flags: an I3D tree of plain crops at window-length clips,
   and with ``--dual`` a tree with the dense landmarker, random AU weights
   and feature files.
3. **Train** the I3D with ``train/run_i3d.py``'s ``main``; the checkpoint
   that ``best.json`` points to is served.
4. **Evaluate** the held-out videos with ``eval/harness.py``'s engine
   (``load_scorer`` → ``run_video`` → ``summarize`` → ``write_csvs``): every
   scored batch runs K1 (``csrc/warp_affine.cu``) on the card.
5. **(--dual)** preprocess the held-out videos with features, carve a
   video-grouped validation set, ``save_split``, then ``train/run_dual.py``'s
   ``main`` and its ``report_median.json``. A failure here is caught and
   reported as ``dual_error``, keeping phases 1-4's result.

Differences from the JAX script:
- detection is each video's ``BenchScene.oracle`` rows (YuNet's ONNX is not
  in the repository), so the JSON line says ``"detections_real": false``;
  rows below ``--det_conf`` would be dropped (the oracle scores 1.0);
- the device comes from ``--device`` (the card by default). Without a card
  the script stops, naming it, before it renders anything; it never
  switches to the CPU or to ``--smoke`` on its own. ``--require_tpu`` is
  accepted and does nothing. ``smoke_cpu`` is true for ``--smoke`` on the
  CPU;
- the JSON line adds ``device``, the served checkpoint (under ``--out``)
  and the bytes each tree takes on disk.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, Iterable

import numpy as np
import torch

SMOKE = dict(frame_hw=(360, 640), face_px=288, frames=48, train_pairs=2, eval_pairs=2,
             crop=112, clip_size=8, batch=4, epochs=2, stride=4, crop_buffer=128,
             batch_clips=2, precise_bn=2, dual_epochs=2, dual_batch=32, dual_samples=256)
FULL = dict(frame_hw=(720, 1280), face_px=288, frames=140, train_pairs=8, eval_pairs=6,
            crop=224, clip_size=32, batch=8, epochs=5, stride=5, crop_buffer=256,
            batch_clips=2, precise_bn=4, dual_epochs=12, dual_batch=64, dual_samples=4096)
LOOP = 24
DET_CONF, TRACK_THRESH = 0.25, 0.35       # the JAX script's detector and tracker flags


def fake_order(seed: int, loop: int = LOOP) -> np.ndarray:
    """The fake video's talking-loop order for pair ``seed``: permutations
    from ``RandomState(10_000 + seed)`` until one moves frames by at least
    ``loop / 4`` on average (run_synth_e2e.py:83-86)."""
    rng = np.random.RandomState(10_000 + seed)
    perm = rng.permutation(loop)
    while np.mean(np.abs(perm - np.arange(loop))) < loop / 4:
        perm = rng.permutation(loop)
    return perm


def scene_of(seed: int, label: str, frame_hw, face_px: int, loop: int = LOOP, device="cuda"):
    """The ``BenchScene`` of video ``label/vid_seed``: a smooth talking loop
    for ``real``, the loop in :func:`fake_order` for ``fake``."""
    from .bench_scene import BenchScene

    order = fake_order(seed, loop) if label == "fake" else None
    return BenchScene(frame_hw, n_faces=1, seed=seed, face_px=face_px, loop=loop,
                      expr_order=order, device=device)


def render_benchmark(root: str, seeds: Iterable[int], n_frames: int, frame_hw, face_px: int,
                     loop: int = LOOP, device="cuda") -> Dict[str, np.ndarray]:
    """Pair ``s`` → ``real/vid_s.y4m`` and ``fake/vid_s.y4m``
    (:func:`scene_of`), rendered on ``device``. Returns each video's oracle
    rows, {path: [F, 1, 15]} (``BenchScene.oracle`` of every frame)."""
    from ..utils.video_io import write_y4m

    oracles = {}
    for s in seeds:
        for label in ("real", "fake"):
            scene = scene_of(s, label, frame_hw, face_px, loop, device)
            path = os.path.join(root, label, f"vid_{s:03d}.y4m")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_y4m(path, (scene.frame(i) for i in range(n_frames)))
            oracles[path] = np.stack([scene.oracle(i) for i in range(n_frames)])
    return oracles


class OracleDetector:
    """A detector that returns the rows the scene drew: call ``switch(path)``
    before a video; each call then returns the next detected frame's rows
    (every ``every``-th frame: the engine detects every ``detect_every``-th,
    the preprocess pipeline every frame), without those below ``conf``."""

    def __init__(self, oracles: Dict[str, np.ndarray], every: int, conf: float):
        self.oracles, self.every, self.conf = oracles, every, conf
        self.rows, self.calls = None, 0

    def switch(self, path: str) -> "OracleDetector":
        self.rows, self.calls = self.oracles[path], 0
        return self

    def __call__(self, frame_bgr) -> np.ndarray:
        rows = self.rows[self.calls * self.every]
        self.calls += 1
        return rows[rows[:, 14] >= self.conf]


def lm_sentinel_stats(clips_dir: str) -> dict:
    """Aggregate the landmark-quality sentinel columns the preprocess
    pipeline logs per clip (``master_clip_log.csv``: lm5_agreement,
    lm_flagged). Returns {} when the log is absent or has no landmarked
    clips."""
    path = os.path.join(clips_dir, "master_clip_log.csv")
    if not os.path.exists(path):
        return {}
    agr, flagged, n = [], 0, 0
    with open(path) as f:
        for row in csv.DictReader(f):
            n += 1
            if row.get("lm_flagged") == "True":
                flagged += 1
            try:
                a = float(row.get("lm5_agreement", "nan"))
            except ValueError:
                a = float("nan")
            if np.isfinite(a):
                agr.append(a)
    if n == 0 or (not agr and flagged == 0):
        # no landmarker ran on this tree: a flag rate of 0.0 would read as
        # "sentinel checked and passed"
        return {}
    out = {"lm_clips": n, "lm_flag_rate": round(flagged / n, 4)}
    if agr:
        out["lm5_agreement_mean"] = round(float(np.mean(agr)), 4)
        out["lm5_agreement_p90"] = round(float(np.percentile(agr, 90)), 4)
    return out


def tree_bytes(root: str) -> int:
    """Bytes of every file under ``root`` (0 when it does not exist)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "synth_e2e"))
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny config, which validates the composition only")
    ap.add_argument("--train_pairs", type=int, default=None)
    ap.add_argument("--eval_pairs", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--fresh", action="store_true",
                    help="wipe --out first (preprocess resume-skips otherwise)")
    ap.add_argument("--require_tpu", action="store_true",
                    help="accepted for the JAX script's command lines; the port never "
                         "downgrades, so it changes nothing")
    ap.add_argument("--dual", action=argparse.BooleanOptionalAction, default=None,
                    help="also run the second detector family end to end: preprocess "
                         "with dense landmarks + AU features, train the dual encoder "
                         "(run_dual), report its video AUC (default: on for the full "
                         "run, off in --smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def preprocess(argv, device, oracles):
    """The preprocess CLI's ``argv`` on ``device``, each video detected by
    its oracle at every frame."""
    from ..data import preprocess as pp

    args = pp.build_parser().parse_args(list(argv) + ["--device", str(device)])
    oracle = OracleDetector(oracles, every=1, conf=args.det_conf)
    return pp.run(args, device, oracle.switch)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("synth_e2e: --device cuda, but torch sees no CUDA device (the "
                         "card); pass --device cpu to run on the CPU")

    from ..data.splits import save_split
    from ..eval import harness
    from ..train import run_dual, run_i3d
    from ..utils.checkpoint import find_last

    cfg = dict(SMOKE if args.smoke else FULL)
    dual = args.dual if args.dual is not None else not args.smoke
    for k in ("train_pairs", "eval_pairs", "frames", "epochs"):
        if getattr(args, k) is not None:
            cfg[k] = getattr(args, k)
    dev = ["--device", str(device)]

    out = args.out
    if args.fresh and os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out, exist_ok=True)
    wall = {}

    # -- 1. render ---------------------------------------------------------
    t0 = time.perf_counter()
    train_root = os.path.join(out, "videos_train")
    eval_root = os.path.join(out, "videos_eval")
    render = dict(n_frames=cfg["frames"], frame_hw=cfg["frame_hw"], face_px=cfg["face_px"],
                  device=device)
    oracles = render_benchmark(train_root, range(0, cfg["train_pairs"]), **render)
    n_train = len(oracles)
    eval_oracles = render_benchmark(eval_root, range(100, 100 + cfg["eval_pairs"]), **render)
    oracles.update(eval_oracles)
    wall["render"] = round(time.perf_counter() - t0, 1)
    print(f"rendered {n_train} train / {len(eval_oracles)} eval videos", file=sys.stderr)

    # -- 2. preprocess -------------------------------------------------------
    # the I3D tree: plain crops at window-length clips; the dual tree: the
    # reference preprocessing (plain crops, clips of 8, dense landmarks + AUs
    # → feature sequences)
    t0 = time.perf_counter()
    common = ["--det_conf", str(DET_CONF), "--track_thresh", str(TRACK_THRESH),
              "--crop_size", str(cfg["crop"])]
    clips_dir = os.path.join(out, "clips_i3d")
    preprocess(["--video_root", train_root, "--out_dir", clips_dir, *common,
                "--clip_length", str(cfg["clip_size"]), "--clip_step", "4",
                "--landmarker", "none"], device, oracles)
    dual_dir_clips = os.path.join(out, "clips_dual")
    if dual:
        preprocess(["--video_root", train_root, "--out_dir", dual_dir_clips, *common,
                    "--landmarker", "dense", "--au_ckpt", "random", "--features"],
                   device, oracles)
    wall["preprocess"] = round(time.perf_counter() - t0, 1)

    # -- 3. train (AltFreezing) ----------------------------------------------
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(out, "ckpt")
    # one pair has no video group to hold out: validation is off there
    val_ratio = "0.15" if cfg["train_pairs"] >= 2 else "0"
    run_i3d.main(["--data", clips_dir, "--out", ckpt_dir,
                  "--clip_size", str(cfg["clip_size"]), "--crop_size", str(cfg["crop"]),
                  "--batch", str(cfg["batch"]), "--epochs", str(cfg["epochs"]),
                  "--base_lr", "0.02", "--warmup_epochs", "1",
                  "--val_ratio", val_ratio, "--resume",
                  "--precise_bn_batches", str(cfg["precise_bn"]), *dev])
    wall["train"] = round(time.perf_counter() - t0, 1)

    last = find_last(ckpt_dir, "i3d")
    if not last:
        raise RuntimeError("training produced no checkpoint")
    epoch, ckpt_path = last
    # serve the checkpoint validation chose (best.json), not the last epoch
    best_meta = os.path.join(ckpt_dir, "best.json")
    if os.path.exists(best_meta):
        with open(best_meta) as f:
            best = json.load(f)
        cand = os.path.join(ckpt_dir, best["best_ckpt"])
        if os.path.exists(cand):
            epoch, ckpt_path = best["best_epoch"] + 1, cand

    # -- 4. evaluate the held-out videos (the streaming harness) --------------
    t0 = time.perf_counter()
    results_dir = os.path.join(out, "results")
    hargs = harness.build_parser().parse_args([
        "--video_root", eval_root, "--out_dir", results_dir,
        "--jax_ckpt", ckpt_path, "--model_crop", str(cfg["crop"]),
        "--clip_size", str(cfg["clip_size"]), "--stride", str(cfg["stride"]),
        "--batch_clips", str(cfg["batch_clips"]), "--crop_buffer", str(cfg["crop_buffer"]),
        "--det_conf", str(DET_CONF), "--track_thresh", str(TRACK_THRESH),
        "--min_det_side", "10", "--threshold", "0.5", "--no_quality", *dev])
    oracle = OracleDetector(eval_oracles, every=hargs.detect_every, conf=hargs.det_conf)
    engine, warmed = harness.build_engine(hargs, detect_fn=oracle)
    try:
        videos = harness.collect_videos(eval_root, hargs.per_class, hargs.seed)
        rows = harness.score_videos(engine, videos, hargs, warmed, 0,
                                    before_video=oracle.switch)
    finally:
        engine.close()
    harness.write_csvs(rows, harness.summarize(rows, 0), results_dir, hargs.threshold)
    wall["eval"] = round(time.perf_counter() - t0, 1)

    with open(os.path.join(results_dir, "summary.csv")) as f:
        summary = next(iter(csv.DictReader(f)))

    result = {
        "metric": "synth_e2e",
        "smoke_cpu": bool(args.smoke and device.type == "cpu"),
        "config": {k: cfg[k] for k in ("frames", "train_pairs", "eval_pairs", "crop",
                                       "clip_size", "epochs")},
        "train_ckpt_epoch": epoch,
        "eval_videos": int(summary["videos"]),
        "video_auc": float(summary["auc_roc"]),
        "video_acc_thr0.5": float(summary["accuracy"]),
        "mean_fps": float(summary["mean_fps"]),
        "phase_wall_s": wall,
        "served_ckpt": os.path.relpath(ckpt_path, out),
        "detections_real": False,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    # the sentinel runs where the dense landmarker runs: the dual tree
    result.update(lm_sentinel_stats(dual_dir_clips if dual else clips_dir))

    # -- 5. (--dual) the second detector family over the feature sequences ----
    clips_eval = os.path.join(out, "clips_eval")
    if dual:
        t0 = time.perf_counter()
        dual_dir = os.path.join(out, "dual")
        try:
            # held-out test = the eval videos the harness scored, with features
            preprocess(["--video_root", eval_root, "--out_dir", clips_eval, *common,
                        "--landmarker", "dense", "--au_ckpt", "random", "--features"],
                       device, oracles)
            tr = sorted(glob.glob(os.path.join(dual_dir_clips, "**", "track_*", "clip_*"),
                                  recursive=True))
            te = sorted(glob.glob(os.path.join(clips_eval, "**", "track_*", "clip_*"),
                                  recursive=True))
            if cfg["train_pairs"] >= 2:
                # video-grouped val: the last rendered pair, real and fake
                vtok = f"vid_{cfg['train_pairs'] - 1:03d}"
                val = [d for d in tr if vtok in d]
                train = [d for d in tr if vtok not in d]
            else:                                   # toy scale: a clip-level carve
                k = max(1, len(tr) // 5)
                train, val = tr[:-k], tr[-k:]
            split_path = os.path.join(out, "dual_split.json")
            save_split({"train": train, "val": val, "test": te}, split_path)

            run_dual.main(["--data", dual_dir_clips, "--split", split_path, "--out", dual_dir,
                           "--T", "8", "--epochs", str(cfg["dual_epochs"]),
                           "--batch", str(cfg["dual_batch"]),
                           "--epoch_samples", str(cfg["dual_samples"]),
                           "--no-dat", "--patience", "6", *dev])
            with open(os.path.join(dual_dir, "report_median.json")) as f:
                rep = json.load(f)
            result["dual_video_auc"] = rep["video_metrics"]["auc_roc"]
            result["dual_clip_auc"] = rep["clip_metrics"]["auc_roc"]
        except Exception as e:  # never lose the phase-1..4 result
            traceback.print_exc(file=sys.stderr)
            result["dual_error"] = f"{type(e).__name__}: {e}"
        wall["dual"] = round(time.perf_counter() - t0, 1)

    result["disk_bytes"] = {name: tree_bytes(os.path.join(out, name)) for name in (
        "videos_train", "videos_eval", "clips_i3d", "clips_dual", "clips_eval", "ckpt")}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
