"""optax's gradient transformations, written out for the port's trainers.

The transforms the JAX trainers chain (``optax.clip_by_global_norm``,
``add_decayed_weights``, ``trace``, ``scale_by_adam``,
``scale_by_learning_rate``, ``identity``, ``chain``, ``adam`` and
``adamw``) and ``cosine_decay_schedule``, each
with optax's arithmetic in optax's order and its state laid out as flax's
``to_state_dict`` writes optax's: a ``chain`` is a tuple with one entry per
transform (a nested chain a nested tuple), each a dict (``{}``,
``{"inner_state": {}}``, ``{"trace": tree}``, ``{"count", "mu", "nu"}``,
``{"count": n}``). ``utils/weights.py`` carries it to and from the JAX
trainers' checkpoints. Trees are ``{name: tensor}`` dicts keyed by the
model's parameter names; ``count`` is a host int.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and
    ``update(updates, state, params) -> (updates, state)`` over trees."""

    init: Callable
    update: Callable


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


def add_decayed_weights(weight_decay: float, mask: Optional[Dict[str, bool]] = None
                        ) -> GradientTransformation:
    """``optax.add_decayed_weights(wd, mask)``: ``g + wd·p`` where the mask is
    true (everywhere without a mask, as in ``optax.adamw``); its state is
    ``masked``'s ``{"inner_state": {}}`` with a mask, else ``{}``."""

    def update(updates, state, params):
        return {k: g + weight_decay * params[k] if mask is None or mask[k] else g
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: {} if mask is None else {"inner_state": {}},
                                  update)


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
            for k, p in params.items()}


def trace(decay: float, nesterov: bool = False, dampening: float = 0.0
          ) -> GradientTransformation:
    """``optax.trace``: ``t = g + decay·t`` (with nesterov the update is
    ``g + decay·t``); with ``dampening`` torch SGD's ``t = decay·t +
    (1 − dampening)·g`` (``stdd_tpu/train/engine_i3d.py:61``
    ``_trace_with_dampening``)."""

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


def scale_by_learning_rate(schedule: Union[float, Callable[[int], float]]
                           ) -> GradientTransformation:
    """``optax.scale_by_learning_rate``: ``-lr(count)·g``, then count + 1; a
    constant LR scales by ``-lr`` and keeps no count (optax's ``scale``)."""
    if not callable(schedule):
        lr = float(schedule)
        return GradientTransformation(
            lambda params: {}, lambda updates, state, params=None: (
                {k: -lr * g for k, g in updates.items()}, state))

    def update(updates, state, params=None):
        step_size = -schedule(state["count"])
        return {k: step_size * g for k, g in updates.items()}, {"count": state["count"] + 1}

    return GradientTransformation(lambda params: {"count": 0}, update)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0
                          ) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``init · ((1 − α) · ½(1 + cos(π t/T))
    + α)`` with ``t`` held at ``T`` after the last step (float64 on the
    host; optax's jitted float32 differs by ~1e-7 relative)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(float(count), float(decay_steps))
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return schedule


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


def identity() -> GradientTransformation:
    """``optax.identity``: the updates unchanged, state ``{}``."""
    return GradientTransformation(lambda params: {}, lambda updates, state, params=None:
                                  (updates, state))


def adam(schedule: Union[float, Callable[[int], float]]) -> GradientTransformation:
    """``optax.adam``: ``scale_by_adam`` → ``scale_by_learning_rate``."""
    return chain(scale_by_adam(), scale_by_learning_rate(schedule))


def adamw(schedule: Union[float, Callable[[int], float]], weight_decay: float
          ) -> GradientTransformation:
    """``optax.adamw``: ``scale_by_adam`` → ``add_decayed_weights`` over every
    parameter (LayerNorm scales and biases too, unlike the parameter groups
    a ``torch.optim.AdamW`` user would set up) → ``scale_by_learning_rate``."""
    return chain(scale_by_adam(), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))
