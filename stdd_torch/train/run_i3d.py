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

Data parallel, with JAX's semantics (``stdd_tpu/train/run_i3d.py:79-336``;
``parallel/mesh.py``):

- ``--mesh``: one logical host over every visible card. The trainer starts
  one rank per card (``--device cpu --num_processes N``: N ranks on the CPU,
  over gloo); every rank reads the same global batches of ``--batch`` and
  takes its rows, so the train, precise-BN and validation batches are the
  single-process run's and so, up to rounding, is the run.
- ``--distributed`` with ``--coordinator host:port --num_processes N
  --process_id I`` (or torchrun's ``env://``): this process joins a job of N
  and loads only its ``process_shard`` of the train clips; the local batch
  is ``--batch / N``; the steps per epoch are the global minimum of the
  ranks' counts; a short batch is skipped with a warning; each validation
  batch is cut to a multiple of N, each rank scores its stripe.

In both, the step averages the gradients over the ranks and BN uses the
global batch's statistics; validation logits are gathered on every rank;
rank 0 alone logs, writes the checkpoints and ``best.json`` while the others
wait at a barrier; ``--resume`` loads on every rank. The checkpoints are the
single-card run's, interchangeable with JAX's.
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
    ap.add_argument("--mesh", action="store_true",
                    help="data-parallel over every visible card, one rank each (batch = "
                         "GLOBAL batch); with --device cpu, --num_processes ranks on the CPU")
    ap.add_argument("--distributed", action="store_true",
                    help="join a multi-process job (torch.distributed) first")
    ap.add_argument("--coordinator", default=None,
                    help="the job's rendezvous host:port (default: torchrun's env://)")
    ap.add_argument("--num_processes", type=int, default=None,
                    help="the job's process count (--mesh --device cpu: ranks to start)")
    ap.add_argument("--process_id", type=int, default=None, help="this process's rank")
    args = ap.parse_args(argv)
    if not (args.mesh or args.distributed):
        for flag in ("coordinator", "num_processes", "process_id"):
            if getattr(args, flag) is not None:
                raise SystemExit(f"--{flag} needs --distributed (or --mesh --device cpu "
                                 "for --num_processes)")
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
    """Train; returns the final state (None in the process that started
    ``--mesh`` ranks of its own)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_i3d: --device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to train on the CPU")
    from ..parallel import mesh

    if args.distributed:
        rank, world = mesh.init_distributed(args.coordinator, args.num_processes,
                                            args.process_id, args.device)
        return train(args, mesh.DataParallel(rank, world), shard=True)
    if not args.mesh:
        return train(args)
    if device.type == "cuda":
        world = torch.cuda.device_count()
        if args.num_processes not in (None, world):
            raise SystemExit(f"--mesh on cuda starts one rank per visible card ({world}); "
                             "--num_processes is for --device cpu")
    else:
        world = args.num_processes or 1
    if world > 1:
        mesh.spawn(_mesh_rank, world, (args,), device=args.device)
        return None
    mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0, args.device)
    try:
        return train(args, mesh.DataParallel(0, 1), shard=False)
    finally:
        torch.distributed.destroy_process_group()


def _mesh_rank(args) -> None:
    from ..parallel import mesh

    dist = torch.distributed
    train(args, mesh.DataParallel(dist.get_rank(), dist.get_world_size()), shard=False)


def train(args, dp=None, shard: bool = False):
    """The training run of :func:`main`; ``dp`` (``parallel.mesh.DataParallel``)
    makes it a rank of a data-parallel job, which with ``shard`` loads its
    own stripe of the train clips and feeds local batches, and otherwise
    takes its rows of the global batches."""
    import logging

    from ..config import I3DConfig
    from ..data.dataset_i3d import I3DClipDataset
    from ..data.splits import make_split
    from ..models.ftcn import FTCN
    from ..models.i3d import I3D, IMAGENET_MEAN, IMAGENET_STD
    from ..parallel.mesh import (COLLECTIVES, all_reduce_, barrier, gather_rows, local_device,
                                 local_rows, process_shard)
    from ..utils.checkpoint import find_last, save_checkpoint
    from ..utils.logging import get_logger, set_logger_dir
    from ..utils.meters import TrainMeter, ValMeter
    from .engine_i3d import I3DTrainArgs, init_i3d_training, precise_bn_update
    from .metrics import metrics_from_logits

    rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
    device = local_device(args.device) if dp is not None else torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)
    log = get_logger("i3d")
    if rank == 0:
        set_logger_dir(args.out)
    else:
        logging.getLogger("stdd_torch").setLevel(logging.WARNING)

    dirs = sorted(glob.glob(os.path.join(args.data, "**", "track_*", "clip_*"), recursive=True))
    split = make_split(dirs, ratios=(1 - args.val_ratio, args.val_ratio, 0.0), seed=args.seed)
    split = ensure_val_floor(split, args.val_ratio)
    # every rank computes the same split (same seed); a sharded rank takes its stripe
    train_dirs = process_shard(split["train"], rank, world) if shard else split["train"]
    train_ds = I3DClipDataset(clip_dirs=train_dirs, T=args.clip_size, is_train=True,
                              seed=args.seed)
    val_ds = I3DClipDataset(clip_dirs=split["val"], T=args.clip_size) if split["val"] else None
    log.info(f"rank {rank}/{world}: train windows={len(train_ds)} "
             f"val={len(val_ds) if val_ds else 0} on {device}")

    # the JAX trainer's s2d stem is the plain convolution here; --ftcn trains
    # the FTCN (stdd_tpu/train/run_i3d.py:151-155)
    cfg = I3DConfig(num_frames=args.clip_size, crop_size=args.crop_size,
                    temporal_only=args.ftcn)
    model_cls = FTCN if args.ftcn else I3D
    model = model_cls(cfg=cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    to_flax, _, opt_to_flax, _ = bridges(model)
    local_batch = args.batch // world
    if local_batch * world != args.batch:
        raise SystemExit(f"--batch {args.batch} is not divisible by the {world} ranks")
    # a sharded rank draws local batches from its own clips; otherwise every
    # rank draws the global batch and keeps its rows
    feed = local_batch if shard else args.batch
    steps_per_epoch = max(1, len(train_ds) // feed)
    if shard and world > 1:
        # every step is a collective: all ranks run the global minimum of
        # their batch counts (run_i3d.py:163-176)
        counts = torch.zeros(world, dtype=torch.int64, device=device)
        counts[rank] = len(train_ds) // feed
        counts = all_reduce_(counts, dp).tolist()
        steps_per_epoch = max(1, min(counts))
        log.info(f"per-rank batch counts {counts} -> {steps_per_epoch} steps/epoch (global min)")
    targs = I3DTrainArgs(
        base_lr=args.base_lr, max_epoch=args.epochs, warmup_epochs=args.warmup_epochs,
        warmup_start_lr=args.base_lr / 4, optimizer=args.optimizer,
        weight_decay=args.weight_decay, alter_freq=args.alter_freq,
        steps_per_epoch=steps_per_epoch, seed=args.seed, grad_clip=1.0,
    )
    state, step_fn, sched = init_i3d_training(model, targs, dp=dp)
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    def normalize_clip(clips: np.ndarray) -> torch.Tensor:
        return (torch.from_numpy(clips).to(device).float() - mean) / std

    def rows(a):
        return local_rows(a, rank, world) if dp is not None and not shard else a

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
                train_ds.batches(feed, seed=args.seed + epoch), steps_per_epoch)):
            if dp is not None and len(ys) != feed:
                # a dataset smaller than one batch comes whole: it cannot
                # split over the ranks (run_i3d.py:258-264)
                log.warning(f"skipping short batch of {len(ys)} rows (batch {feed})")
                continue
            t0 = time.perf_counter()
            meter.iter_tic()
            x = normalize_clip(rows(clips))
            y = torch.from_numpy(rows(ys)).to(device)
            t1 = time.perf_counter()
            state, m = step_fn(state, x, y, args.seed)
            t2 = time.perf_counter()
            loss, acc = float(m["loss"]), float(m["acc"])
            t3 = time.perf_counter()
            meter.iter_toc()
            meter.update_stats(loss, sched(state.step), len(ys) * (world if shard else 1), acc=acc)
            meter.log_iter_stats(epoch, it)
            if timing:
                log.info(f"timing iter {it}: data {t0 - t_last:.4f}s "
                         f"upload+norm {t1 - t0:.4f}s dispatch {t2 - t1:.4f}s "
                         f"block {t3 - t2:.4f}s")
            t_last = time.perf_counter()
        meter.log_epoch_stats(epoch)

        if args.precise_bn_batches:
            n_pb = args.precise_bn_batches
            if shard and world > 1:
                n_pb = min(n_pb, steps_per_epoch)   # as many batches on every rank
            pb = (normalize_clip(rows(c)) for c, _ in train_ds.batches(feed, seed=999)
                  if dp is None or len(c) == feed)
            state = precise_bn_update(model, state, itertools.islice(pb, n_pb), dp=dp)

        if val_ds is not None and len(val_ds):
            logits, ys_all = [], []
            with torch.inference_mode():
                for clips, ys in val_ds.batches(args.batch, shuffle=False):
                    if dp is None:
                        logits.append(model(normalize_clip(clips))[:, 0].float().cpu().numpy())
                        ys_all.append(ys)
                        continue
                    # every rank reads the same batches, cut to a multiple of
                    # the ranks; each scores its stripe (run_i3d.py:304-329)
                    n = (len(ys) // world) * world
                    if n == 0:
                        continue
                    out = model(normalize_clip(local_rows(clips[:n], rank, world)))[:, 0]
                    logits.append(gather_rows(out.float(), dp).cpu().numpy())
                    ys_all.append(ys[:n])
            if logits:
                vm = metrics_from_logits(np.concatenate(logits), np.concatenate(ys_all))
                val_meter.update(vm["roc_auc"], epoch)
        if rank == 0:
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
        if dp is not None:
            barrier(dp)                 # the others wait for rank 0's files
    if dp is not None:
        log.info(f"collectives: {dict(COLLECTIVES)}")
    return state


if __name__ == "__main__":
    main()
