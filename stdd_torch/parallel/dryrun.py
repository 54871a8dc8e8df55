"""The multi-card dry run: the three data-parallel programs over ``n`` ranks.

Port of ``__graft_entry__.py:24-150`` (``dryrun_multichip``), at its tiny
shapes and with its random weights:

1. the whole masked-AltFreezing I3D train step (I3D-R50, 4×32², a global
   batch of ``2n``: gradients averaged over the ranks, BN over the global
   batch),
2. the dual-encoder (AU+LMK, d_model 16, one layer) train step with the
   AltFreezing mask, ``slerp=False`` and ``dat=False`` as JAX shards it,
   Adam at 1e-3,
3. sharded serving (``make_sharded_score_fn``: each rank runs K1 and the
   I3D on its rows, the probs gathered).

``dryrun_multichip(n, device)`` starts ``n`` ranks on localhost on the
card (NCCL, one card a rank; gloo carries the CUDA tensors where there are
fewer cards than ranks) or, when asked, on the CPU (gloo), and prints one
line a program and rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import DataParallel, local_rows, make_sharded_score_fn, spawn


def dryrun_rank(dp: DataParallel, device) -> dict:
    """This rank's part of the three programs; returns their losses and
    probs (the probs of the whole batch)."""
    from ..config import I3DConfig
    from ..models.dual_encoder import DualEncoderAU_LMK
    from ..models.i3d import I3D
    from ..ops.align import STD_POINTS_256
    from ..runtime.classifier import ClipScorer
    from ..train.altfreeze import active_mask_from_labels, dual_labels, dual_phase_active
    from ..train.engine_dual import DualTrainArgs, make_dual_train_step
    from ..train.engine_i3d import I3DTrainArgs, init_i3d_training
    from ..train.optim import adam
    from ..train.step import TrainState

    device = torch.device(device)
    n, tag = dp.world, f"dryrun_multichip({dp.world}) rank {dp.rank}"
    out = {}

    # -- program 1: the I3D AltFreezing train step ------------------------------
    cfg = I3DConfig(num_frames=4, crop_size=32)
    model = I3D(cfg).to(device)
    args = I3DTrainArgs(base_lr=1e-3, max_epoch=1, warmup_epochs=0, warmup_start_lr=1e-3,
                        steps_per_epoch=2, alter_freq=2)
    state, step_fn, _ = init_i3d_training(model, args, dp=dp)
    clips = torch.ones((2 * n, cfg.num_frames, cfg.crop_size, cfg.crop_size, 3), device=device)
    labels = torch.ones((2 * n,), device=device)
    state, m = step_fn(state, local_rows(clips, dp.rank, n), local_rows(labels, dp.rank, n), 0)
    assert state.step == 1
    out["i3d_loss"] = float(m["loss"])
    print(f"{tag}: i3d loss={out['i3d_loss']:.4f} ok", flush=True)

    # -- program 2: the dual-encoder (AU+LMK) train step ------------------------
    dmodel = DualEncoderAU_LMK(au_dim=4, lmk_dim=6, d_model=16, depth=1, heads=2).to(device)
    rng = np.random.RandomState(0)
    B, T = 2 * n, 4
    batch = {"A": rng.randn(B, T, 4).astype(np.float32),
             "L": rng.randn(B, T, 6).astype(np.float32),
             "y": (rng.rand(B) > 0.5).astype(np.float32)}
    batch = {k: torch.from_numpy(local_rows(v, dp.rank, n)).to(device) for k, v in batch.items()}
    dargs = DualTrainArgs(epochs=1, batch=B, lr=1e-3, slerp=False, dat=False)
    tx = adam(dargs.lr)
    params = dict(dmodel.named_parameters())
    dstate = TrainState(params, {}, tx.init(params), 0)
    active = active_mask_from_labels(dual_labels(params), dual_phase_active("joint"))
    dstep = make_dual_train_step(dmodel, tx, dargs, dp=dp)
    dstate, parts = dstep(dstate, batch, active, 0.0, 0)
    assert dstate.step == 1
    out["dual_loss"] = float(parts["loss"])
    print(f"{tag}: dual loss={out['dual_loss']:.4f} ok", flush=True)

    # -- program 3: sharded serving ---------------------------------------------
    scorer = ClipScorer.random_init(cfg=I3DConfig(num_frames=4, crop_size=64),
                                    dtype=torch.float32, device=device)
    Bs = 2 * n
    crops = rng.randint(0, 255, (Bs, 4, 96, 96, 3)).astype(np.uint8)
    boxes = np.tile(np.array([5, 5, 90, 90], np.float32), (Bs, 4, 1))
    lm5 = np.tile((np.asarray(STD_POINTS_256) * 0.3 + 10).astype(np.float32), (Bs, 4, 1, 1))
    probs = make_sharded_score_fn(scorer, dp)(crops, boxes, lm5, np.ones(Bs, bool))
    assert probs.shape == (Bs,) and np.isfinite(probs).all()
    out["probs"] = probs
    print(f"{tag}: scorer p0={float(probs[0]):.4f} ok", flush=True)
    return out


def _rank(device: str) -> dict:
    import torch.distributed as dist

    from ..ops.bottleneck import fused_bottleneck
    from ..ops.warp import warp_affine
    from .mesh import local_device

    out = dryrun_rank(DataParallel(dist.get_rank(), dist.get_world_size()), local_device(device))
    out["launches"] = {f.__name__: f.launches for f in (warp_affine, fused_bottleneck)}
    return out


def dryrun_multichip(n: int, device: str = "cuda") -> list:
    """Run the three programs over ``n`` new ranks on localhost; returns
    each rank's losses, probs and launches of K1 and K2 (counted from the
    rank process's start), in rank order; raises if any rank fails."""
    return spawn(_rank, n, (device,), device=device)
