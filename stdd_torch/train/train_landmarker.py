"""Train the dense FaceMesh-topology landmarker on faces rendered on the card.

Own copy of ``stdd_tpu/train/train_landmarker.py``. The landmarker is
distilled from the procedural face model: each step draws fresh parameters
from a ``torch.Generator``, renders and randomizes them on the card
(``models/facemesh.py``), and :class:`LandmarkNet` learns to invert the
renderer; nothing crosses from the host. Loss = parameter regression
(rigid + theta) + 20 × landmark reconstruction on the indices the feature
builders read (KEY_LANDMARKS ∪ MP68). The optimizer is ``optax.adam`` over
``cosine_decay_schedule(lr, steps, alpha=0.1)``, written out in
``train/optim.py``.

CLI::

    python -m stdd_torch.train.train_landmarker --steps 3000 --out landmarker.pkl [--device cpu]

It runs on the card (``--device cuda``, the default) and stops when there is
none. The saved pickle is the flax tree both packages'
``DenseLandmarker.from_checkpoint`` read.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.facemesh import (DenseLandmarker, LandmarkNet, augment_renders, canonical_mesh,
                               reconstruct, render_faces, sample_holdout_params, sample_params)
from . import optim


def _key_indices() -> np.ndarray:
    from ..data.features import KEY_LANDMARKS_IDXS, MP68_IDX

    return np.asarray(sorted(set(KEY_LANDMARKS_IDXS) | set(MP68_IDX)), np.int32)


def make_train_step(net: LandmarkNet, tx: optim.GradientTransformation, canon: torch.Tensor,
                    key_idx, batch: int = 256, w_param: float = 1.0, w_lmk: float = 20.0,
                    exclude_holdout: bool = True, augment: bool = True):
    """One train step over ``net``'s parameters, in place: draw → render →
    randomize → forward → param + landmark loss → ``tx`` → apply. Defaults
    hold out the HOLDOUT_ROT / HOLDOUT_LIGHT bands and apply
    ``augment_renders``. ``step(opt_state, generator)`` draws from
    ``generator``; ``step(opt_state, draws=(imgs, rigid, theta))`` takes
    given draws. Returns ``(opt_state, loss, (l_param, l_lmk))``."""
    names = [n for n, _ in net.named_parameters()]
    params = dict(net.named_parameters())
    key_idx = torch.as_tensor(np.asarray(key_idx), dtype=torch.long, device=canon.device)

    @torch.no_grad()
    def draw(generator: torch.Generator):
        rigid, theta, style = sample_params(generator, batch, exclude_holdout=exclude_holdout,
                                            device=canon.device)
        if augment:
            imgs = augment_renders(generator, render_faces(rigid, theta, style))
        else:
            imgs = render_faces(rigid, theta, style, generator=generator)
        return imgs, rigid, theta

    def step(opt_state, generator: Optional[torch.Generator] = None, draws=None):
        imgs, rigid, theta = draws if draws is not None else draw(generator)
        pred_rigid, pred_theta = net(imgs)
        l_param = torch.mean((pred_rigid - rigid) ** 2) + torch.mean((pred_theta - theta) ** 2)
        gt = reconstruct(canon, rigid, theta)[:, key_idx]
        pr = reconstruct(canon, pred_rigid, pred_theta)[:, key_idx]
        l_lmk = torch.mean((gt - pr) ** 2)
        loss = w_param * l_param + w_lmk * l_lmk
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        updates, opt_state = tx.update(dict(zip(names, grads)), opt_state, params)
        with torch.no_grad():
            for n in names:
                params[n].add_(updates[n])
        return opt_state, loss.detach(), (l_param.detach(), l_lmk.detach())

    return step


@torch.no_grad()
def holdout_error(lm: DenseLandmarker, n: int = 64, seed: int = 11,
                  draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None) -> float:
    """Mean |err| (crop-normalized units) on the key landmarks over renders
    drawn entirely from the held-out bands (roll and lighting out of the
    training domain); ``draws`` = (rigid, theta, style) replaces the draw
    from ``seed``."""
    dev = lm.device
    key_idx = torch.as_tensor(_key_indices(), dtype=torch.long, device=dev)
    if draws is None:
        draws = sample_holdout_params(torch.Generator(dev).manual_seed(seed), n, device=dev)
    rigid, theta, style = [t.to(dev) for t in draws]
    imgs = render_faces(rigid, theta, style)
    canon = torch.from_numpy(canonical_mesh()).to(dev, rigid.dtype)
    gt = reconstruct(canon, rigid, theta)[:, key_idx]
    pr, _ = lm.forward(imgs)
    return float(torch.abs(pr[:, key_idx] - gt).mean())


def train(steps: int = 3000, lr: float = 3e-4, seed: int = 0, batch: int = 256,
          log_every: int = 100, params=None, verbose: bool = True,
          exclude_holdout: bool = True, augment: bool = True, device="cuda") -> DenseLandmarker:
    """Train and return a ready :class:`DenseLandmarker` on ``device`` with
    ``history`` (the loss at each logged step). ``params`` is a flax tree to
    start from; without it the net gets flax's initializers, drawn from
    ``seed``."""
    device = torch.device(device)
    lm = DenseLandmarker(variables=params, seed=seed, device=device)
    net = lm.net.train()
    tx = optim.adam(optim.cosine_decay_schedule(lr, max(steps, 1), alpha=0.1))
    opt_state = tx.init(dict(net.named_parameters()))
    canon = torch.from_numpy(canonical_mesh()).to(device)
    step = make_train_step(net, tx, canon, _key_indices(), batch=batch,
                           exclude_holdout=exclude_holdout, augment=augment)
    gen = torch.Generator(device).manual_seed(seed)

    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        opt_state, loss, (l_param, l_lmk) = step(opt_state, gen)
        if verbose and (i % log_every == 0 or i == steps - 1):
            lf = float(loss)       # host fetch = sync point
            history.append(lf)
            print(f"step {i:5d}  loss {lf:.5f}  param {float(l_param):.5f} "
                  f"lmk {float(l_lmk):.5f}  {time.perf_counter() - t0:.1f}s", flush=True)
    net.eval()
    lm.history = history
    return lm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="landmarker.pkl")
    ap.add_argument("--include_holdout", action="store_true",
                    help="train on the full parameter space (no held-out bands)")
    ap.add_argument("--no_augment", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_landmarker: --device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to train on the CPU")
    lm = train(steps=args.steps, lr=args.lr, seed=args.seed, batch=args.batch,
               exclude_holdout=not args.include_holdout,
               augment=not args.no_augment, device=args.device)
    print(f"holdout_error {holdout_error(lm):.5f}  (crop-normalized units)")
    lm.save(args.out)
    print(f"saved {args.out}")
    return lm


if __name__ == "__main__":
    main()
