"""AltFreezing I3D training CLI.

Port of ``stdd_tpu/train/run_i3d.py`` (``ensure_val_floor`` :20, ``main``
:57): trains the I3D-ResNet50 (or, with ``--ftcn``, the FTCN of
``models/ftcn.py``: ``temporal_only``, no space-to-depth stem, the sidecar's
``temporal_only`` true) from a preprocessed clip tree with the
alternating temporal/spatial schedule, SGD-momentum (or Adam) with warmup
and a cosine LR, gradient clipping at a global norm of 1, optional
precise-BN, per-epoch validation AUC, epoch checkpoints in the JAX
trainer's format (``i3d_{epoch}.msgpack`` with ``params``, ``batch_stats``
and ``opt_state``, and its ``.json`` sidecar), the ``best.json`` pointer and
resume.

    python -m stdd_torch.train.run_i3d --data TREE --out RUN \\
        [--clip_size 32 --batch 8 --base_lr 0.04 --alter_freq 20 ...] [--device cpu]

It runs on the card (``--device cuda``, the default) and refuses to fall
back to the CPU when there is none; ``--device cpu`` trains on the CPU. A
checkpoint either package writes resumes in the other. ``--resume`` also
takes the best validation AUC, its epoch and the history from ``best.json``,
so a resumed run keeps protecting and pointing at the best checkpoint.
``STDD_TRAIN_TIMING=1`` logs each iteration's split into host data, upload
and normalize, the step's dispatch and the wait for its result.

Not ported yet, and refused by name: the data-parallel flags ``--mesh``,
``--distributed``, ``--coordinator``, ``--num_processes``, ``--process_id``
(ROADMAP §1 item 5).
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import time

import numpy as np
import torch

REFUSED = {
    "mesh": "data-parallel training is not ported yet (ROADMAP §1 item 5)",
    "distributed": "multi-host training is not ported yet (ROADMAP §1 item 5)",
}


def ensure_val_floor(split: dict, val_ratio: float) -> dict:
    """Floor the video-grouped val carve at one held-out video group.

    With few videos, per-bucket rounding in ``make_split`` can leave
    ``val=[]``. When validation was asked for (``val_ratio > 0``) and came
    back empty, the last identity-linked group of each label moves from
    train to val (one label's groups alone would give a NaN AUC), never
    emptying train; with fewer than two groups there is nothing to hold out
    and the run stops."""
    if val_ratio <= 0 or split["val"]:
        return split
    from ..data.dataset import label_from_dir
    from ..data.splits import group_by_video, link_identity_groups

    groups = link_identity_groups(group_by_video(split["train"]))
    if len(groups) < 2:
        raise SystemExit(
            f"--val_ratio {val_ratio} produced an empty validation split "
            f"and train has only {len(groups)} video group(s) — add videos "
            f"or pass --val_ratio 0 explicitly")
    by_label: dict = {}
    for k in sorted(groups):
        by_label.setdefault(label_from_dir(groups[k][0]), []).append(k)
    held_keys = [ks[-1] for ks in by_label.values()]
    if len(held_keys) >= len(groups):   # never empty the train split
        held_keys = held_keys[: len(groups) - 1]
    held = {d for k in held_keys for d in groups[k]}
    split["val"] = sorted(held)
    split["train"] = [d for d in split["train"] if d not in held]
    return split


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--clip_size", type=int, default=32)
    ap.add_argument("--crop_size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--base_lr", type=float, default=0.04)
    ap.add_argument("--warmup_epochs", type=float, default=10.0)
    ap.add_argument("--alter_freq", type=int, default=20)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--val_ratio", type=float, default=0.15)
    ap.add_argument("--precise_bn_batches", type=int, default=0)
    ap.add_argument("--max_to_keep", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ftcn", action="store_true", help="use the FTCN variant")
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the JAX trainer's data-parallel flags (not ported yet)
    ap.add_argument("--mesh", action="store_true", help="not ported yet")
    ap.add_argument("--distributed", action="store_true", help="not ported yet")
    ap.add_argument("--coordinator", default=None, help="not ported yet")
    ap.add_argument("--num_processes", type=int, default=None, help="not ported yet")
    ap.add_argument("--process_id", type=int, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag, why in REFUSED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: {why}")
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag}: {REFUSED['distributed']}")
    return args


def _load_best(out_dir: str, val_meter) -> None:
    """Seed ``val_meter`` from ``best.json``, so a resumed run keeps its best
    epoch (and keeps protecting its checkpoint) until a better one comes."""
    path = os.path.join(out_dir, "best.json")
    if not os.path.isfile(path):
        return
    with open(path) as f:
        best = json.load(f)
    val_meter.best = float(best["best_val_auc"])
    val_meter.best_epoch = int(best["best_epoch"])
    val_meter.history = list(best.get("history", []))


def bridges(model):
    """``(to_flax, from_flax, opt_to_flax, opt_from_flax)`` for the trainer's
    model: the I3D's own bridge, or the zoo's naming rule for the FTCN
    (``utils/weights.py``)."""
    from ..models.ftcn import FTCN
    from ..utils import weights as w

    if not isinstance(model, FTCN):
        return (w.i3d_torch_to_flax, w.i3d_flax_to_torch, w.i3d_opt_state_to_flax,
                w.i3d_opt_state_from_flax)
    return (w.torch_to_flax, lambda v, m=None: w.flax_to_torch(v, m, "FTCN"),
            lambda s: w.opt_state_to_flax(s, lambda t: w.torch_to_flax(t)["params"]),
            lambda tree, like: w.opt_state_from_flax(
                tree, like, lambda t: w.flax_to_torch({"params": t})))


def load_train_checkpoint(path: str, model, state, log=None):
    """Load a trainer checkpoint of either package into ``model`` (params
    and BN statistics, in place) and return ``state`` with its optimizer
    state. A checkpoint that does not cover the model raises; one without
    ``opt_state`` (an older layout) keeps the fresh optimizer state, with a
    warning: the momentum restarts from zero."""
    from ..utils.checkpoint import load_checkpoint, tolerant_merge

    to_flax, from_flax, _, opt_from_flax = bridges(model)
    raw = load_checkpoint(path)
    merged, report = tolerant_merge(to_flax(model.state_dict()),
                                    {k: raw[k] for k in ("params", "batch_stats") if k in raw})
    if report["missing"] or report["shape_mismatch"]:
        raise ValueError(f"{path} does not cover the model: missing={report['missing'][:5]} "
                         f"shape_mismatch={report['shape_mismatch'][:5]}")
    with torch.no_grad():
        for k, v in from_flax(merged, model).items():
            dst = state.params.get(k, state.batch_stats.get(k))
            if dst is not None:
                dst.copy_(v)
    opt_state = state.opt_state
    if "opt_state" in raw:
        opt_state = opt_from_flax(raw["opt_state"], state.opt_state)
    elif log is not None:
        log.warning("checkpoint has no optimizer state; momentum restarts from zero")
    return state.__class__(state.params, state.batch_stats, opt_state, state.step)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_i3d: --device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to train on the CPU")

    from ..config import I3DConfig
    from ..data.dataset_i3d import I3DClipDataset
    from ..data.splits import make_split
    from ..models.ftcn import FTCN
    from ..models.i3d import I3D, IMAGENET_MEAN, IMAGENET_STD
    from ..utils.checkpoint import find_last, save_checkpoint
    from ..utils.logging import get_logger, set_logger_dir
    from ..utils.meters import TrainMeter, ValMeter
    from .engine_i3d import I3DTrainArgs, init_i3d_training, precise_bn_update
    from .metrics import metrics_from_logits

    os.makedirs(args.out, exist_ok=True)
    set_logger_dir(args.out)
    log = get_logger("i3d")

    dirs = sorted(glob.glob(os.path.join(args.data, "**", "track_*", "clip_*"), recursive=True))
    split = make_split(dirs, ratios=(1 - args.val_ratio, args.val_ratio, 0.0), seed=args.seed)
    split = ensure_val_floor(split, args.val_ratio)
    train_ds = I3DClipDataset(clip_dirs=split["train"], T=args.clip_size, is_train=True,
                              seed=args.seed)
    val_ds = I3DClipDataset(clip_dirs=split["val"], T=args.clip_size) if split["val"] else None
    log.info(f"train windows={len(train_ds)} val={len(val_ds) if val_ds else 0} on {device}")

    # the JAX trainer's s2d stem is the plain convolution here; --ftcn trains
    # the FTCN (stdd_tpu/train/run_i3d.py:151-155)
    cfg = I3DConfig(num_frames=args.clip_size, crop_size=args.crop_size,
                    temporal_only=args.ftcn)
    model_cls = FTCN if args.ftcn else I3D
    model = model_cls(cfg=cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    to_flax, _, opt_to_flax, _ = bridges(model)
    steps_per_epoch = max(1, len(train_ds) // args.batch)
    targs = I3DTrainArgs(
        base_lr=args.base_lr, max_epoch=args.epochs, warmup_epochs=args.warmup_epochs,
        warmup_start_lr=args.base_lr / 4, optimizer=args.optimizer,
        weight_decay=args.weight_decay, alter_freq=args.alter_freq,
        steps_per_epoch=steps_per_epoch, seed=args.seed, grad_clip=1.0,
    )
    state, step_fn, sched = init_i3d_training(model, targs)
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    def normalize_clip(clips: np.ndarray) -> torch.Tensor:
        return (torch.from_numpy(clips).to(device).float() - mean) / std

    val_meter = ValMeter()
    start_epoch = 0
    if args.resume:
        last = find_last(args.out, "i3d")
        if last:
            start_epoch, path = last
            state = load_train_checkpoint(path, model, state, log)
            state.step = start_epoch * steps_per_epoch
            _load_best(args.out, val_meter)
            log.info(f"resumed from epoch {start_epoch}")

    timing = os.environ.get("STDD_TRAIN_TIMING") == "1"
    for epoch in range(start_epoch, args.epochs):
        meter = TrainMeter(steps_per_epoch, args.epochs, log_period=10)
        t_last = time.perf_counter()
        for it, (clips, ys) in enumerate(itertools.islice(
                train_ds.batches(args.batch, seed=args.seed + epoch), steps_per_epoch)):
            t0 = time.perf_counter()
            meter.iter_tic()
            x = normalize_clip(clips)
            y = torch.from_numpy(ys).to(device)
            t1 = time.perf_counter()
            state, m = step_fn(state, x, y, args.seed)
            t2 = time.perf_counter()
            loss, acc = float(m["loss"]), float(m["acc"])
            t3 = time.perf_counter()
            meter.iter_toc()
            meter.update_stats(loss, sched(state.step), len(ys), acc=acc)
            meter.log_iter_stats(epoch, it)
            if timing:
                log.info(f"timing iter {it}: data {t0 - t_last:.4f}s "
                         f"upload+norm {t1 - t0:.4f}s dispatch {t2 - t1:.4f}s "
                         f"block {t3 - t2:.4f}s")
            t_last = time.perf_counter()
        meter.log_epoch_stats(epoch)

        if args.precise_bn_batches:
            pb = (normalize_clip(c) for c, _ in train_ds.batches(args.batch, seed=999))
            state = precise_bn_update(model, state, itertools.islice(pb, args.precise_bn_batches))

        if val_ds is not None and len(val_ds):
            logits, ys_all = [], []
            with torch.inference_mode():
                for clips, ys in val_ds.batches(args.batch, shuffle=False):
                    logits.append(model(normalize_clip(clips))[:, 0].float().cpu().numpy())
                    ys_all.append(ys)
            if logits:
                vm = metrics_from_logits(np.concatenate(logits), np.concatenate(ys_all))
                val_meter.update(vm["roc_auc"], epoch)
        tree = to_flax(model.state_dict())
        tree["opt_state"] = opt_to_flax(state.opt_state)
        save_checkpoint(args.out, "i3d", epoch + 1, tree, max_to_keep=args.max_to_keep,
                        metadata={"crop_size": args.crop_size, "clip_size": args.clip_size,
                                  "temporal_only": bool(args.ftcn), "epoch": epoch + 1},
                        protect=(f"i3d_{val_meter.best_epoch + 1}.msgpack"
                                 if val_meter.best_epoch >= 0 else None))
        if val_meter.best_epoch >= 0:
            with open(os.path.join(args.out, "best.json"), "w") as f:
                json.dump({"best_epoch": val_meter.best_epoch,
                           "best_ckpt": f"i3d_{val_meter.best_epoch + 1}.msgpack",
                           "best_val_auc": val_meter.best,
                           "history": val_meter.history}, f, indent=1)
    return state


if __name__ == "__main__":
    main()
