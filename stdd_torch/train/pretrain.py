"""Self-supervised landmark pretraining (VoxCeleb real-vs-shuffled).

Port of ``stdd_tpu/train/pretrain.py`` (reference
``dualrun/train/pretrain.py``): an ``LMKDisc`` (``models/dual_encoder.py``)
learns to tell real landmark sequences (label 1) from time-shuffled ones
(label 0, :func:`make_shuffled`, which keeps the padding in place);
:func:`remap_pretrained_to_lmk` grafts the pretrained encoder onto a
``DualEncoderAU_LMK``'s landmark branch.

The random draws: the shuffle's uniform keys come from a ``torch.Generator``
seeded from ``(seed, step)`` (``train/step.py::fold_in``) unless the caller
passes them (the parity tests pass JAX's); the real and the shuffled pass
share one dropout draw, as JAX passes one ``drop_rng`` to both.
:func:`pretrain_lmk` trains the model's current weights (JAX initialises
them from ``PRNGKey(seed)`` itself).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.dual_encoder import LMKDisc, lengths_to_mask
from .losses import bce_with_logits
from .optim import GradientTransformation, adamw
from .step import TrainState, fold_in

WEIGHT_DECAY = 1e-4                # optax.adamw's default, which JAX's pretrain keeps


def make_shuffled(X: torch.Tensor, lengths: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Permute the time axis of [B, T, D] independently per sequence,
    valid frames only: uniform keys [B, T] (``keys``, else drawn from
    ``generator``) are sorted within the valid prefix (pads get +inf keys
    and keep their place), and the permuted frames are scattered back into
    the valid slots in order."""
    B, T, D = X.shape
    pad = lengths_to_mask(lengths, T)
    if keys is None:
        keys = torch.rand((B, T), generator=generator, device=X.device)
    keys = torch.where(pad, torch.full_like(keys, float("inf")), keys)
    order = torch.argsort(keys, dim=1, stable=True)
    permuted = torch.take_along_dim(X, order[:, :, None], dim=1)
    slot_keys = pad.float() + torch.arange(T, device=X.device)[None, :] * 1e-6
    slots = torch.argsort(slot_keys, dim=1, stable=True)
    out = torch.zeros_like(X).scatter(1, slots[:, :, None].expand(B, T, D), permuted)
    return torch.where(pad[:, :, None], X, out)


def make_pretrain_step(model: LMKDisc, tx: GradientTransformation):
    """``step(state, L, lengths, seed, keys=None) -> (state, {"loss",
    "acc"})``: BCE over the real (1) and shuffled (0) passes, one optimizer
    update of ``state.params`` in place."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)

    def step(state: TrainState, L, lengths, seed: int, keys=None):
        step_seed = fold_in(seed, state.step)
        generator.manual_seed(step_seed)
        Ls = make_shuffled(L, lengths, generator, keys)
        drop_seed = fold_in(step_seed, 1)
        generator.manual_seed(drop_seed)
        logit_r = model(L, lengths=lengths, train=True, generator=generator)
        generator.manual_seed(drop_seed)          # the same dropout draw for both passes
        logit_s = model(Ls, lengths=lengths, train=True, generator=generator)
        logits = torch.cat([logit_r, logit_s])
        y = torch.cat([torch.ones_like(logit_r), torch.zeros_like(logit_s)])
        loss = bce_with_logits(logits, y)
        names = list(state.params)
        grads = dict(zip(names, torch.autograd.grad(loss, [state.params[k] for k in names])))
        with torch.no_grad():
            acc = ((logits > 0) == (y > 0.5)).float().mean()
            updates, opt = tx.update(grads, state.opt_state, state.params)
            for k, p in state.params.items():
                p.add_(updates[k])
        return TrainState(state.params, state.batch_stats, opt, state.step + 1), {
            "loss": loss.detach(), "acc": acc}

    return step


def pretrain_lmk(
    model: LMKDisc,
    sequences: np.ndarray,      # [N, T, lmk_dim] (zero-padded)
    lengths: np.ndarray,        # [N]
    epochs: int = 5,
    batch: int = 64,
    lr: float = 3e-4,
    seed: int = 123,
    log=print,
    device="cuda",
) -> Dict[str, Any]:
    """AdamW (``optax.adamw(lr)``) over ``model`` on ``device``: each epoch
    visits ``RandomState(seed + ep)``'s permutation in batches, the last
    partial batch dropped. Returns the trained ``params`` (the model's
    state dict) and the per-epoch mean ``history``."""
    model.to(device)
    params = dict(model.named_parameters())
    dtype = next(iter(params.values())).dtype
    tx = adamw(lr, WEIGHT_DECAY)
    state = TrainState(params, {}, tx.init(params), 0)
    step_fn = make_pretrain_step(model, tx)
    N = len(sequences)
    history = []
    for ep in range(epochs):
        order = np.random.RandomState(seed + ep).permutation(N)
        losses, accs = [], []
        for s in range(0, N - batch + 1, batch):
            idx = order[s: s + batch]
            state, m = step_fn(
                state, torch.as_tensor(sequences[idx], device=device, dtype=dtype),
                torch.as_tensor(lengths[idx], device=device), seed)
            losses.append(float(m["loss"]))
            accs.append(float(m["acc"]))
        history.append({"epoch": ep + 1, "loss": float(np.mean(losses)),
                        "acc": float(np.mean(accs))})
        log(f"[pretrain {ep + 1}/{epochs}] loss={history[-1]['loss']:.4f} "
            f"acc={history[-1]['acc']:.3f}")
    return {"params": model.state_dict(), "history": history}


def remap_pretrained_to_lmk(pretrain_params: Mapping[str, torch.Tensor],
                            dual_params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of a ``DualEncoderAU_LMK`` state dict with the pretrained
    ``enc.*`` entries grafted onto ``lmk_enc.*`` (remap_pretrain_to_lmk.py:24);
    an entry the dual model lacks, or of another shape, is skipped."""
    out = {k: v.detach().clone() for k, v in dual_params.items()}
    for k, v in pretrain_params.items():
        if not k.startswith("enc."):
            continue
        dst = "lmk_enc." + k[len("enc."):]
        if dst in out and tuple(out[dst].shape) == tuple(v.shape):
            out[dst] = v.detach().clone()
    return out
