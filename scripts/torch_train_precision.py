"""How far apart float32, float64 and bf16 training steps of the port's I3D
trainer land on the CPU: the numbers behind the tolerances of
``tests/test_torch_train.py`` and of ``chip_smoke.py``'s ``train`` phase.

    JAX_PLATFORMS=cpu python scripts/torch_train_precision.py

Prints one JSON object:

- ``f32_vs_f64_grad``: the largest gap between the port's float32 and
  float64 gradients, over max(1, max |float64 gradient|) of the parameter,
  at the test geometry and at the card check's (8×64², all widths), batch 2;
- ``jax_vs_port_f32_grad_norm``: the relative gap of the two packages'
  float32 gradient norms after one step at the test geometry;
- ``adam_f64_param_gap``: the largest parameter gap after one float64 Adam
  step of both packages at a warmup LR of 0.01 and of 0.001;
- ``bf16_vs_f32``: the loss, BN statistics, parameters and gradient norm of
  the bf16 step against the float32 step on three batches.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_train as T  # noqa: E402
from stdd_torch.config import I3DConfig  # noqa: E402
from stdd_torch.models.i3d import I3D  # noqa: E402
from stdd_torch.train.losses import bce_with_logits  # noqa: E402
from stdd_torch.utils.weights import i3d_flax_to_torch  # noqa: E402
from torch_port_helpers import max_rel_err, port_i3d_variables  # noqa: E402


def batches(n, shape):
    rng = np.random.RandomState(7)
    return [(rng.randn(*shape).astype(np.float32),
             np.array([0.0, 1.0], np.float32)[rng.permutation(2)]) for _ in range(n)]


def f32_vs_f64(cfg: dict) -> float:
    v = port_i3d_variables(I3DConfig(**cfg), seed=0)
    x, y = batches(1, (2, cfg["num_frames"], cfg["crop_size"], cfg["crop_size"], 3))[0]
    grads = {}
    for dt in (torch.float32, torch.float64):
        m = I3D(I3DConfig(**cfg), dtype=dt)
        m.load_state_dict(i3d_flax_to_torch(v, m))
        m.to(dt)
        loss = bce_with_logits(m(torch.from_numpy(x).to(dt), train=True), torch.from_numpy(y))
        loss.backward()
        grads[dt] = {k: p.grad.double().numpy() for k, p in m.named_parameters()}
    return max(max_rel_err(grads[torch.float32][k], grads[torch.float64][k])
               for k in grads[torch.float64])


def main():
    out = {"f32_vs_f64_grad": {
        "test geometry 4x32^2 width 8": f32_vs_f64(T.CFG),
        "card check 8x64^2 width 64": f32_vs_f64(dict(num_frames=8, crop_size=64,
                                                      dropout_rate=0.0))}}
    v = port_i3d_variables(I3DConfig(**T.CFG), seed=0)
    bs = batches(3, (2, 4, 32, 32, 3))
    x, y = bs[0]
    _, state, step = T.port_side(v, compute=torch.float32)
    _, pm = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
    _, jstate, jstep = T.jax_side(v, f64=False)
    _, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    out["jax_vs_port_f32_grad_norm"] = abs(float(pm["grad_norm"]) / float(jm["grad_norm"]) - 1)
    out["adam_f64_param_gap"] = {}
    for lr in (0.01, 0.001):
        kw = dict(optimizer="adam", weight_decay=1e-3, base_lr=4 * lr, warmup_start_lr=lr)
        model, state, step = T.port_side(v, **kw)
        state, _ = step(state, torch.from_numpy(x).double(), torch.from_numpy(y), 0)
        with jax.enable_x64(True):
            _, jstate, jstep = T.jax_side(v, **kw)
            jstate, _ = jstep(jstate, jnp.asarray(x, jnp.float64), jnp.asarray(y),
                              jax.random.PRNGKey(0))
            out["adam_f64_param_gap"][str(lr)] = T.tree_err(T.port_trees(model, state)[0],
                                                            jstate.params)
    drift = []
    for x, y in bs:
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            model, state, step = T.port_side(v, compute=dt)
            state, m = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
            res[dt] = (float(m["loss"]), float(m["grad_norm"])) + T.port_trees(model, state)[:2]
        (l32, g32, p32, s32), (l16, g16, p16, s16) = res[torch.float32], res[torch.bfloat16]
        drift.append({"loss": max_rel_err(l16, l32), "batch_stats": T.tree_err(s16, s32),
                      "params": T.tree_err(p16, p32), "grad_norm": abs(g16 / g32 - 1)})
    out["bf16_vs_f32"] = drift
    print(json.dumps(out))


if __name__ == "__main__":
    main()
