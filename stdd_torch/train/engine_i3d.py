"""AltFreezing trainer for the I3D classifier (the CVPR'23 mechanism).

Port of ``stdd_tpu/train/engine_i3d.py``: ``I3DTrainArgs`` :38,
``make_i3d_optimizer`` :83, ``make_lr_schedule`` :116,
``make_i3d_train_step`` :133, ``init_i3d_training`` :170 and
``precise_bn_update`` :182 (reference ``slowfast/models/optimizer.py``,
``slowfast/utils/lr_policy.py``, ``slowfast/utils/bn_helper.py:11``).

The optimizer is optax's chain written out, transform by transform, in
optax's order, because the order decides the numbers:

- SGD: ``clip_by_global_norm`` (over the masked gradients) →
  ``add_decayed_weights`` masked off BN → the optional BN decay → the
  momentum ``trace`` (or torch's dampened trace) →
  ``scale_by_learning_rate`` at the chain's own ``count``;
- Adam: ``clip_by_global_norm`` → ``scale_by_adam`` →
  ``add_decayed_weights`` → ``scale_by_learning_rate``.

``torch.optim.SGD`` would skip a frozen parameter's momentum buffer or move
the parameter; here a frozen parameter's trace keeps accumulating
``wd·p`` while its value stays bit-identical, as in JAX. The chain's state
is a tuple with one entry per transform, each a dict laid out as
``flax.serialization.to_state_dict`` writes optax's state (``{}``,
``{"inner_state": {}}``, ``{"trace": tree}``, ``{"count", "mu", "nu"}``,
``{"count": n}``), so ``utils/weights.py`` carries it to and from the JAX
trainer's checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .altfreeze import i3d_alt_labels, i3d_phase_mask, masked_update
from .lr_policy import cosine_lr, step_decay, with_warmup
from .step import TrainState, bce_with_logits

Tree = Dict[str, torch.Tensor]


@dataclass
class I3DTrainArgs:
    """SOLVER defaults of the shipped configs (i3d_ori.py:33-43 inline yaml
    + setting/ftcn_tt.yaml SOLVER)."""

    base_lr: float = 0.04
    lr_policy: str = "cosine"          # cosine | step
    max_epoch: int = 100
    momentum: float = 0.9
    weight_decay: float = 1e-4
    bn_weight_decay: float = 0.0
    warmup_epochs: float = 10.0
    warmup_start_lr: float = 0.01
    optimizer: str = "sgd"             # sgd | adam
    nesterov: bool = False
    dampening: float = 0.0
    step_size: float = 100.0           # for lr_policy=step
    gamma: float = 0.5
    alter_freq: int = 20               # AltFreezing swap period (iterations)
    grad_clip: Optional[float] = None
    steps_per_epoch: int = 100
    seed: int = 0


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and
    ``update(updates, state, params) -> (updates, state)`` over trees."""

    init: Callable
    update: Callable


def _is_bn(name: str) -> bool:
    return "bn" in name.split(".")


def global_norm(tree: Tree) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of every leaf's sum
    of squares."""
    return torch.sqrt(sum((g * g).sum() for g in tree.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return {k: torch.where(trigger, g, (g / g_norm) * max_norm)
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: {}, update)


def add_decayed_weights(weight_decay: float, mask: Dict[str, bool]) -> GradientTransformation:
    """``optax.add_decayed_weights(wd, mask)``: ``g + wd·p`` where the mask is
    true; its state is ``masked``'s ``{"inner_state": {}}``."""

    def update(updates, state, params):
        return {k: g + weight_decay * params[k] if mask[k] else g
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: {"inner_state": {}}, update)


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
            for k, p in params.items()}


def trace(decay: float, nesterov: bool = False, dampening: float = 0.0
          ) -> GradientTransformation:
    """``optax.trace``: ``t = g + decay·t`` (with nesterov the update is
    ``g + decay·t``); with ``dampening`` torch SGD's ``t = decay·t +
    (1 − dampening)·g`` (engine_i3d.py:61 ``_trace_with_dampening``)."""

    def update(updates, state, params=None):
        t = state["trace"]
        if dampening:
            new = {k: decay * t[k] + (1.0 - dampening) * g for k, g in updates.items()}
            return new, {"trace": new}
        new = {k: g + decay * t[k] for k, g in updates.items()}
        out = {k: g + decay * new[k] for k, g in updates.items()} if nesterov else new
        return out, {"trace": new}

    return GradientTransformation(lambda params: {"trace": _zeros(params)}, update)


def _f32_pow(base: float, count: int) -> float:
    return float(np.float32(base) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """``optax.scale_by_adam``: moments ``(1−b)·g^k + b·m``, bias corrections
    at the incremented count, ``m̂ / (sqrt(v̂ + eps_root) + eps)``."""

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params=None):
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in updates.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in updates.items()}
        count = state["count"] + 1
        c1 = float(np.float32(1) - np.float32(_f32_pow(b1, count)))
        c2 = float(np.float32(1) - np.float32(_f32_pow(b2, count)))
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2 + eps_root) + eps) for k in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_learning_rate(schedule: Callable[[int], float]) -> GradientTransformation:
    """``optax.scale_by_learning_rate``: ``-lr(count)·g``, then count + 1."""

    def update(updates, state, params=None):
        step_size = -schedule(state["count"])
        return {k: step_size * g for k, g in updates.items()}, {"count": state["count"] + 1}

    return GradientTransformation(lambda params: {"count": 0}, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in txs)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(txs, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def make_i3d_optimizer(params: Tree, args: I3DTrainArgs,
                       lr_schedule: Callable[[int], float]) -> GradientTransformation:
    """SGD-momentum or Adam with weight decay masked off the BN parameters
    (construct_optimizer semantics), as the JAX chain."""
    not_bn = {k: not _is_bn(k) for k in params}
    txs = []
    if args.grad_clip:
        txs.append(clip_by_global_norm(args.grad_clip))
    if args.optimizer == "sgd":
        txs.append(add_decayed_weights(args.weight_decay, not_bn))
        if args.bn_weight_decay:
            txs.append(add_decayed_weights(args.bn_weight_decay,
                                           {k: not m for k, m in not_bn.items()}))
        if args.dampening and args.nesterov:
            raise ValueError("nesterov requires dampening=0 (torch SGD)")
        txs += [trace(args.momentum, args.nesterov, args.dampening),
                scale_by_learning_rate(lr_schedule)]
    elif args.optimizer == "adam":
        txs += [scale_by_adam(), add_decayed_weights(args.weight_decay, not_bn),
                scale_by_learning_rate(lr_schedule)]
    else:
        raise ValueError(f"optimizer {args.optimizer!r} is not sgd or adam")
    return chain(*txs)


def make_lr_schedule(args: I3DTrainArgs) -> Callable[[int], float]:
    """The policy tabulated per step in float32, read at ``min(step,
    total)``, as the JAX schedule's table."""
    if args.lr_policy == "cosine":
        pol = cosine_lr(args.base_lr, args.max_epoch)
    else:
        pol = step_decay(args.base_lr, args.step_size, args.gamma)
    pol = with_warmup(pol, args.warmup_epochs, args.warmup_start_lr)
    total = args.max_epoch * args.steps_per_epoch
    table = np.asarray([pol(s / args.steps_per_epoch) for s in range(total + 1)], np.float32)

    def sched(step: int) -> float:
        return float(table[min(int(step), total)])

    return sched


def _fold_in(seed: int, step: int) -> int:
    """A dropout seed for iteration ``step`` of a run seeded ``seed``, so a
    resumed run draws the masks an unbroken one would (``jax.random.fold_in``
    plays this part in JAX)."""
    return (seed * 1_000_003 + step) % (1 << 63)


def make_i3d_train_step(model: nn.Module, tx: GradientTransformation, labels: Dict[str, str],
                        alter_freq: int, loss_fn=bce_with_logits) -> Callable:
    """``step(state, clips, targets, seed) -> (state, metrics)``: one
    AltFreezing iteration. The phase mask comes from ``state.step``; the
    dropout mask from a generator on the model's device seeded from
    ``(seed, state.step)``. ``metrics`` are tensors on the device (``loss``,
    ``acc``, ``grad_norm`` of the unmasked gradients) and the host's
    ``phase_temporal``."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)

    def step(state: TrainState, clips: torch.Tensor, targets: torch.Tensor, seed: int):
        mask = i3d_phase_mask(labels, state.step, alter_freq)
        generator.manual_seed(_fold_in(seed, state.step))
        names = list(state.params)
        logits = model(clips, train=True, generator=generator)
        loss = loss_fn(logits, targets)
        grads = dict(zip(names, torch.autograd.grad(loss, [state.params[k] for k in names])))
        with torch.no_grad():
            opt_state = masked_update(tx, grads, state.opt_state, state.params, mask)
            probs = torch.sigmoid(logits.detach().float().reshape(-1))
            metrics = {
                "loss": loss.detach(),
                "acc": ((probs > 0.5) == (targets.reshape(-1) > 0.5)).float().mean(),
                "grad_norm": global_norm(grads),
                "phase_temporal": 1.0 if (state.step // alter_freq) % 2 == 0 else 0.0,
            }
        return TrainState(state.params, state.batch_stats, opt_state, state.step + 1), metrics

    return step


def init_i3d_training(model: nn.Module, args: I3DTrainArgs
                      ) -> Tuple[TrainState, Callable, Callable[[int], float]]:
    """Draw the model's initial weights from ``args.seed`` (the JAX model's
    initializers, on torch's generator) and build the state, the step and
    the LR schedule."""
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    params = dict(model.named_parameters())
    sched = make_lr_schedule(args)
    tx = make_i3d_optimizer(params, args, sched)
    state = TrainState.of(model, tx.init(params))
    step_fn = make_i3d_train_step(model, tx, i3d_alt_labels(params), args.alter_freq)
    return state, step_fn, sched


def precise_bn_update(model: nn.Module, state: TrainState, batches: Iterable[torch.Tensor]
                      ) -> TrainState:
    """Replace every BN's running statistics by the average of their true
    values over ``batches`` (bn_helper.py:11 compute_and_update_bn_stats):
    each batch runs in train mode with the BN momentum at 1, so the running
    statistics become that batch's mean and biased variance, which are
    summed. (JAX recovers the same numbers from its EMA update.)"""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm3d)]
    momenta = [bn.momentum for bn in bns]
    generator = torch.Generator(device=next(model.parameters()).device).manual_seed(0)
    sums, count = None, 0
    try:
        for bn in bns:
            bn.momentum = 1.0
        with torch.no_grad():
            for clips in batches:
                model(clips, train=True, generator=generator)
                if sums is None:
                    sums = {k: v.clone() for k, v in state.batch_stats.items()}
                else:
                    for k, v in state.batch_stats.items():
                        sums[k] += v
                count += 1
    finally:
        for bn, m in zip(bns, momenta):
            bn.momentum = m
    if count:
        with torch.no_grad():
            for k, v in state.batch_stats.items():
                v.copy_(sums[k] / count)
    return state
