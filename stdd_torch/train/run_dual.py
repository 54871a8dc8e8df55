"""Dual-encoder training CLI (the reference's ``dualrun/cli/run.py``).

Port of ``stdd_tpu/train/run_dual.py``: builds the feature dataset from a
clip tree (or a saved split JSON), the balanced per-technique sampler and
the model, and runs :func:`train_dual` with the shipped defaults; writes
``best.msgpack`` (the params tree in flax's format, which the JAX model
scores too), the threshold and temperature sidecars, ``args.json``,
``history.json``, ``log.txt`` and, with a test split, ``report_median.json``
from the evaluator.

    python -m stdd_torch.train.run_dual --data DIR --out runs/test1 \\
        [--split split.json] [--epochs 30 --batch 256 --d_model 256 ...] [--device cpu]

It runs on the card (``--device cuda``, the default) and stops when there
is none; ``--device cpu`` trains on the CPU. The starting weights are drawn
from ``--seed`` with flax's initializers.
"""

from __future__ import annotations

import argparse
import glob
import os

import torch


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True, help="clip-feature tree root")
    ap.add_argument("--split", default=None, help="split JSON (made by data.splits)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--T", type=int, default=8)
    ap.add_argument("--stitch_k", type=int, default=1)
    ap.add_argument("--zscore", default="clip", choices=["clip", "global", "none"])
    ap.add_argument("--norm_stats", default=None)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dropout", type=float, default=0.15)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--epoch_samples", type=int, default=120000)
    ap.add_argument("--heldout_tech", default=None)
    ap.add_argument("--focal", action="store_true")
    ap.add_argument("--dat", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--dat_lambda", type=float, default=0.1)
    ap.add_argument("--lam_align", type=float, default=0.05)
    ap.add_argument("--lam_uniform", type=float, default=0.005)
    ap.add_argument("--slerp", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--train_agg", default="none", choices=["none", "track", "video"],
                    help="aggregated main loss: noisy-OR over the group's "
                         "clips in the batch (reference engine.py:517)")
    ap.add_argument("--altfreeze", type=int, default=0)
    ap.add_argument("--patience", type=int, default=10)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--aug_noise_au", type=float, default=0.05)
    ap.add_argument("--aug_noise_lmk", type=float, default=0.01)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_dual: --device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to train on the CPU")

    from ..data.dataset import DualFeaturesClipDataset
    from ..data.splits import load_split, make_split
    from ..eval.best import evaluate_checkpoint
    from ..models.dual_encoder import DualEncoderAU_LMK
    from ..utils.logging import get_logger, set_logger_dir
    from .altfreeze import AltFreezeCfg
    from .engine_dual import DualTrainArgs, train_dual
    from .samplers import BalancedPerTechLOOSampler, BalancedPerTechSampler

    os.makedirs(args.out, exist_ok=True)
    set_logger_dir(args.out)
    log = get_logger("train")

    if args.split:
        split = load_split(args.split)
    else:
        dirs = sorted(glob.glob(os.path.join(args.data, "**", "track_*", "clip_*"),
                                recursive=True))
        split = make_split(dirs, seed=args.seed)
    if not split.get("val"):
        # tiny trees: the video-grouped ratios can round val down to zero —
        # carve the tail of train instead (clip-level, so same-video leakage
        # is possible; only reachable on toy datasets)
        tr = list(split["train"])
        if len(tr) < 2:
            raise RuntimeError("need at least 2 clips to form a val split")
        k = max(1, len(tr) // 5)
        split = dict(split, val=tr[-k:], train=tr[:-k])
        log.warning(f"empty val split; carved {k} clips from train")

    def make_ds(dirs, is_train):
        return DualFeaturesClipDataset(
            clip_dirs=dirs, T=args.T, stitch_k=args.stitch_k, is_train=is_train,
            zscore=args.zscore, norm_stats_path=args.norm_stats,
            aug_noise_au=args.aug_noise_au if is_train else 0.0,
            aug_noise_lmk=args.aug_noise_lmk if is_train else 0.0,
            seed=args.seed,
        )

    train_ds = make_ds(split["train"], True)
    val_ds = make_ds(split["val"], False)
    test_ds = make_ds(split["test"], False) if split.get("test") else None

    epoch_samples = min(args.epoch_samples, 2 * (len(train_ds) // 2))
    epoch_samples -= epoch_samples % 2
    sampler_kw = dict(epoch_samples=max(2, epoch_samples), seed_base=args.seed)
    if args.heldout_tech:
        sampler = BalancedPerTechLOOSampler(train_ds.labels, train_ds.tech_names,
                                            args.heldout_tech, **sampler_kw)
    else:
        sampler = BalancedPerTechSampler(train_ds.labels, train_ds.tech_names, **sampler_kw)

    model = DualEncoderAU_LMK(
        au_dim=train_ds.au_dim, lmk_dim=train_ds.lmk_dim, d_model=args.d_model,
        depth=args.layers, heads=args.heads, dropout=args.dropout,
        use_dat=args.dat, domain_classes=train_ds.n_domains, seed=args.seed,
    ).to(device)
    targs = DualTrainArgs(
        epochs=args.epochs, batch=args.batch, lr=args.lr, wd=args.wd,
        focal=args.focal, dat=args.dat, dat_lambda=args.dat_lambda,
        train_agg=args.train_agg,
        lam_align=args.lam_align, lam_uniform=args.lam_uniform, slerp=args.slerp,
        altfreeze=AltFreezeCfg(enabled=bool(args.altfreeze)),
        patience=args.patience, seed=args.seed,
    )
    log.info(f"train clips={len(train_ds)} val={len(val_ds)} "
             f"test={len(test_ds) if test_ds is not None else 0} on {device}")

    train = train_ds.load_all()
    val = val_ds.load_all()
    res = train_dual(model, train, val, targs, out_dir=args.out, sampler=sampler,
                     log=log.info,
                     # per-epoch re-materialisation re-draws the feature
                     # augmentations; val stays a single fixed draw
                     train_provider=train_ds.load_all)
    log.info(f"best val auc {res['best_val_auc']:.4f}  T*={res['temperature']:.3f}")

    if test_ds is not None and len(test_ds):
        test = test_ds.load_all()
        meta = [(test["tech"][i], int(test["vid"][i]), int(test["trk"][i]))
                for i in range(len(test["y"]))]
        report = evaluate_checkpoint(
            model, None, test, meta,
            # the evaluator thresholds temperature-scaled probs, so it takes
            # the threshold chosen on scaled probs, not best_threshold
            threshold=res["threshold_calibrated"], temperature=res["temperature"],
            bootstrap=2000, out_path=os.path.join(args.out, "report_median.json"),
        )
        log.info(f"test: clip_auc={report['clip_metrics']['auc_roc']:.4f} "
                 f"video_auc={report['video_metrics']['auc_roc']:.4f}")
    return res


if __name__ == "__main__":
    main()
