"""The multigrid long-cycle schedule end to end on the card: evidence that
the trainer, checkpoints and precise-BN compose across shapes.

Port of ``scripts/measure_train_epoch.py``. It runs the full long-cycle
schedule (``train/multigrid.py``, the rebuild of the reference's
``slowfast/utils/multigrid.py:13``) on data generated on the card from an
explicit ``torch.Generator`` — real clips are a smooth temporal signal over
a fixed pattern, fake clips the same frames shuffled in time, the signal
the temporal kernels exist to catch (JAX's recipe, :94-115) — switching
the batches' shape where ``MultigridSchedule.update`` says the shape
changed. (JAX compiles a new executable there; the port's step takes any
shape, and cuDNN chooses its algorithms at a shape's first step, which
``first_step_s`` records.) At the first epoch of the final shape it saves a
checkpoint (``utils/checkpoint``, flax's msgpack layout),
builds a fresh model, state and step, restores into them and asserts the
restore bitwise (a preemption drill), and goes on from the restored state.
It ends with precise-BN over fresh batches of the last shape
(``bn_helper.py:11`` semantics) and a held-out AUC.

At the defaults the schedule is ``MultigridConfig()`` at the production
shape, I3D-R50 32×224² in bf16 (JAX's ``s2d_stem`` is the plain
convolution here, as everywhere in the port): batch 64 × 8×158², then
32 × 16×158², 16 × 16×224² and 8 × 32×224², 45 epochs. ``--smoke`` keeps
JAX's tiny configuration (I3D 8×32² in float32, a 4-epoch schedule) and is
for checking the harness, e.g. on the CPU with ``--device cpu``.

Usage::

    python -m stdd_torch.train.measure_multigrid [--steps_per_epoch 8]
    python -m stdd_torch.train.measure_multigrid --smoke --device cpu

It prints one JSON line (JAX's field names, ``multigrid_long_cycle_epoch``;
per shape also the peak device memory) and per-epoch lines on stderr. It
runs on the card unless ``--device cpu`` asks for the CPU, and stops when
the card is asked for and torch sees none.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .multigrid import MultigridConfig, MultigridSchedule

SMOKE = MultigridConfig(default_b=2, default_t=8, default_s=32, solver_steps=(0, 2, 3),
                        solver_max_epoch=4, epoch_factor=1.0)


def make_batch(generator: torch.Generator, B: int, T: int, S: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A separable batch on ``device``: real = a fixed spatial pattern times
    a per-clip sinusoid in time plus noise; fake = the same frames in a
    random temporal order; labels fake = 1, each clip fake with
    probability 1/2. → (clips [B, T, S, S, 3] float32, labels [B] float32)."""
    kw = dict(generator=generator, device=device)
    pattern = torch.randn(B, 1, S, S, 3, **kw)
    omega = 0.3 + 0.7 * torch.rand(B, 1, 1, 1, 1, **kw)
    phase = 2 * math.pi * torch.rand(B, 1, 1, 1, 1, **kw)
    t = torch.arange(T, dtype=torch.float32, device=device).reshape(1, T, 1, 1, 1)
    real = pattern * torch.sin(phase + omega * t) + 0.05 * torch.randn(B, T, S, S, 3, **kw)
    order = torch.argsort(torch.rand(B, T, **kw), dim=1)
    fake = torch.take_along_dim(real, order[:, :, None, None, None], dim=1)
    y = torch.rand(B, **kw) < 0.5
    clips = torch.where(y[:, None, None, None, None], fake, real)
    return clips, y.float()


def _leaves(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Every array of a nested dict/tuple tree, by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def state_leaves(state) -> Dict[str, np.ndarray]:
    """Parameters, BN statistics and optimizer state as numpy, by path."""
    return _leaves({"params": state.params, "batch_stats": state.batch_stats,
                    "opt_state": state.opt_state})


class Run:
    """One model, its train state and step at ``dtype`` on ``device``."""

    def __init__(self, cfg, dtype, targs, device):
        from ..models.i3d import I3D
        from .engine_i3d import init_i3d_training

        self.model = I3D(cfg, dtype=dtype).to(device)
        self.state, self.step_fn, _ = init_i3d_training(self.model, targs)


def checkpoint_drill(run: Run, make_run, out_dir: str, epoch: int) -> Tuple[Run, dict]:
    """Save ``run``'s state through ``utils/checkpoint``, restore it into a
    fresh run from ``make_run()``, and compare every leaf bitwise. → (the
    restored run, the drill's report)."""
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.weights import i3d_opt_state_to_flax, i3d_torch_to_flax
    from .run_i3d import load_train_checkpoint

    tree = i3d_torch_to_flax(run.model.state_dict())
    tree["opt_state"] = i3d_opt_state_to_flax(run.state.opt_state)
    tree["step"] = np.asarray(run.state.step, np.int64)
    t0 = time.perf_counter()
    path = save_checkpoint(out_dir, "i3d_mg", epoch, tree)
    before = state_leaves(run.state)
    step = run.state.step
    del run, tree
    fresh = make_run()
    fresh.state = load_train_checkpoint(path, fresh.model, fresh.state)
    fresh.state.step = int(load_checkpoint(path)["step"])
    seconds = time.perf_counter() - t0
    after = state_leaves(fresh.state)
    same = sorted(before) == sorted(after) and all(
        a.dtype == after[k].dtype and np.array_equal(a, after[k]) for k, a in before.items())
    return fresh, {"epoch": epoch, "step": int(step), "restored_step": fresh.state.step,
                   "leaves": len(before), "bitwise_identical": bool(same),
                   "save_restore_s": seconds}


def measure(mg: MultigridConfig, cfg, dtype, device, steps_per_epoch: int, base_lr: float,
            alter_freq: int, precise_bn_batches: int, eval_batches: int, out_dir: str,
            seed: int = 0, log=None) -> dict:
    """The schedule end to end; → the JSON record."""
    from .engine_i3d import I3DTrainArgs, precise_bn_update
    from .metrics import metrics_from_logits

    sched = MultigridSchedule(mg)
    epochs = sched.max_epoch
    targs = I3DTrainArgs(base_lr=base_lr, max_epoch=epochs, warmup_epochs=2.0,
                         warmup_start_lr=base_lr / 4, alter_freq=alter_freq,
                         steps_per_epoch=steps_per_epoch, grad_clip=1.0, seed=seed)

    def make_run():
        return Run(cfg, dtype, targs, device)

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t_start = time.perf_counter()
    run = make_run()
    gen = torch.Generator(device=device).manual_seed(seed)
    times: Dict[Tuple[int, int, int], List[float]] = {}
    first: Dict[Tuple[int, int, int], float] = {}
    peak: Dict[Tuple[int, int, int], float] = {}
    losses: List[float] = []
    accs: List[float] = []
    drill: Optional[dict] = None
    # the drill fires mid-way through the first epoch at the final shape, as
    # JAX's does (a tiny schedule may have none: then the last epoch)
    drill_epoch = next((e for e in range(epochs)
                        if sched.long_cycle_shape(e) == sched.schedule[-1][1]), epochs - 1)
    shape = None
    switches = 0
    for epoch in range(epochs):
        new_shape, changed = sched.update(epoch, shape)
        bf, T, S = shape = new_shape
        B = bf * mg.default_b
        key = (B, T, S)
        if changed:
            switches += 1
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
        for it in range(steps_per_epoch):
            if epoch == drill_epoch and it == steps_per_epoch // 2:
                run, drill = checkpoint_drill(run, make_run, out_dir, epoch)
                if not drill["bitwise_identical"]:
                    raise AssertionError(f"measure_multigrid: the restore is not bitwise: {drill}")
            clips, y = make_batch(gen, B, T, S, device)
            sync()
            t0 = time.perf_counter()
            run.state, m = run.step_fn(run.state, clips, y, seed)
            loss = float(m["loss"])                       # the host fetch ends the step
            dt = time.perf_counter() - t0
            if key not in first:
                first[key] = dt
                times[key] = []
            else:
                times[key].append(dt)
            losses.append(loss)
            accs.append(float(m["acc"]))
        if cuda:
            peak[key] = max(peak.get(key, 0.0), torch.cuda.max_memory_allocated(device) / 2 ** 20)
        if log is not None:
            print(json.dumps({"epoch": epoch, "shape": [B, T, S], "loss": losses[-1],
                              "acc": accs[-1]}), file=log, flush=True)
        del clips, y

    # precise-BN over fresh batches of the last shape (bn_helper.py:11)
    bf, T, S = sched.schedule[-1][1]
    B = bf * mg.default_b
    pb_gen = torch.Generator(device=device).manual_seed(seed + 1)
    stem = run.state.batch_stats[next(iter(run.state.batch_stats))].detach().clone()
    sync()
    t0 = time.perf_counter()
    run.state = precise_bn_update(run.model, run.state, (
        make_batch(pb_gen, B, T, S, device)[0] for _ in range(precise_bn_batches)))
    sync()
    precise_bn_s = time.perf_counter() - t0
    stem_moved = float((run.state.batch_stats[next(iter(run.state.batch_stats))]
                        - stem).abs().max())

    ev_gen = torch.Generator(device=device).manual_seed(seed + 2)
    logits, ys = [], []
    with torch.inference_mode():
        for _ in range(eval_batches):
            clips, y = make_batch(ev_gen, B, T, S, device)
            logits.append(run.model(clips)[:, 0].float().cpu().numpy())
            ys.append(y.cpu().numpy())
    vm = metrics_from_logits(np.concatenate(logits), np.concatenate(ys))

    def med(v):
        return float(np.median(v)) if v else None

    return {
        "metric": "multigrid_long_cycle_epoch",
        "smoke_cpu": device.type == "cpu",
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "dtype": str(dtype).replace("torch.", ""),
        "schedule_epochs": epochs,
        "steps_per_epoch": steps_per_epoch,
        "total_steps": len(losses),
        "shape_switches": switches,
        "shapes": [
            {"shape": list(k),
             "steps_per_s": 1.0 / med(v) if v else None,
             "ms_per_step": 1000.0 * med(v) if v else None,
             "clips_per_s": k[0] / med(v) if v else None,
             "first_step_s": first[k], "timed_steps": len(v),
             "peak_mib": peak.get(k)}
            for k, v in times.items()],
        "loss_first5": losses[:5],
        "loss_last5": losses[-5:],
        "acc_last5": accs[-5:],
        "losses_finite": bool(np.isfinite(losses).all()),
        "resume_drill": drill,
        "precise_bn_batches": precise_bn_batches,
        "precise_bn_s": precise_bn_s,
        "precise_bn_stem_moved": stem_moved,
        "eval_clips": int(sum(len(x) for x in ys)),
        "eval_auc_after_precise_bn": float(vm["roc_auc"]),
        "wall_s": time.perf_counter() - t_start,
    }


def main(argv: Optional[Iterable[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps_per_epoch", type=int, default=8,
                    help="steps per schedule epoch")
    ap.add_argument("--base_lr", type=float, default=0.02)
    ap.add_argument("--alter_freq", type=int, default=20)
    ap.add_argument("--precise_bn_batches", type=int, default=8)
    ap.add_argument("--eval_batches", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="checkpoint directory of the drill (default: a temporary one)")
    ap.add_argument("--smoke", action="store_true",
                    help="JAX's tiny configuration (I3D 8×32², float32, 4 epochs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(list(argv) if argv is not None else None)

    from ..config import I3DConfig
    from ..utils.misc import check_device

    device = check_device(args.device, "measure_multigrid")
    if args.smoke:
        mg, cfg, dtype = SMOKE, I3DConfig(num_frames=8, crop_size=32), torch.float32
    else:
        # the production schedule at the production shape
        mg, cfg, dtype = MultigridConfig(), I3DConfig(num_frames=32, crop_size=224), torch.bfloat16
    with tempfile.TemporaryDirectory() as tmp:
        rec = measure(mg, cfg, dtype, device, args.steps_per_epoch, args.base_lr,
                      args.alter_freq, args.precise_bn_batches, args.eval_batches,
                      args.out or tmp, log=sys.stderr)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
