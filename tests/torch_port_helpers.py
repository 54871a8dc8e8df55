"""Shared inputs for the port's parity tests (``tests/test_torch_*.py``).

Both packages get the same numpy arrays: the JAX model's initializers are
drawn once, the BatchNorm statistics and scales are then randomized with a
numpy seed (the JAX init zeroes every block's final BN scale, which would
make each residual branch dead and the parity vacuous), and the tree is
handed as numpy to the JAX side and through the weight bridge to the torch
side.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np


def randomize_bn(tree: Mapping, rng: np.random.RandomState) -> dict:
    """Copy of a flax variables tree (nested dicts of numpy arrays) with
    random BN scales, shifts, means and variances. The final BN of each
    bottleneck (``branch2/c/bn``) keeps a small scale so activations keep
    their magnitude through every residual block."""

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if path[-1:] == ("bn",):
                final = path[-3:-1] == ("branch2", "c")
                if k == "scale":
                    v = rng.uniform(*((0.1, 0.3) if final else (0.7, 1.3)), v.shape)
                elif k in ("bias", "mean"):
                    v = rng.normal(0.0, 0.1, v.shape)
                elif k == "var":
                    v = rng.uniform(0.7, 1.3, v.shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return walk(tree, ())


def jax_i3d_variables(cfg, seed: int = 0) -> dict:
    """Random-BN variables of the JAX I3D for ``cfg`` (a ``stdd_tpu``
    ``I3DConfig``), as nested dicts of numpy float32 arrays."""
    import jax
    import jax.numpy as jnp

    from stdd_tpu.models.i3d import I3D

    model = I3D(cfg=cfg)
    sample = jnp.zeros((1, cfg.num_frames, cfg.crop_size, cfg.crop_size, 3))
    v = jax.jit(lambda r: model.init(r, sample, train=False))(jax.random.PRNGKey(seed))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed + 1)
    return {"params": randomize_bn(v["params"], rng),
            "batch_stats": randomize_bn(v["batch_stats"], rng)}


def max_rel_err(got, want) -> float:
    """max |got − want| over max(1, max |want|): an absolute bound for
    values of order one, a relative one for larger values."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def fake_detector(n_faces: int = 1):
    """Deterministic moving 'faces' as YuNet rows (x, y, w, h, 5 landmarks,
    score): the rows of ``tests/test_engine.py::make_fake_detector``, numpy
    only, so one detector serves both packages' engines."""
    from stdd_torch.ops.align import STD_POINTS_256

    state = {"f": 0}

    def detect(frame_bgr):
        f = state["f"]
        state["f"] += 1
        rows = []
        for k in range(n_faces):
            x = 30 + 40 * k + 1.5 * f
            y = 40 + 30 * k + 0.5 * f
            w, h = 60.0, 70.0
            lm = (STD_POINTS_256 * (w / 256.0) + np.array([x, y])).reshape(-1)
            rows.append([x, y, w, h, *lm, 0.92])
        return np.asarray(rows, np.float32)

    return detect


def port_i3d_variables(cfg, seed: int = 0) -> dict:
    """Random-BN variables for ``cfg`` (a ``stdd_torch`` ``I3DConfig``)
    drawn by the port's initializers and carried to a flax tree by the
    weight bridge: the same tree as ``jax_i3d_variables`` gives, without
    tracing the JAX model's init (about 10 s on a CPU), for tests that need
    only equal weights on both sides, not the JAX initializers."""
    import torch

    from stdd_torch.runtime.classifier import ClipScorer
    from stdd_torch.utils.weights import i3d_torch_to_flax

    sd = ClipScorer.random_init(cfg=cfg, seed=seed, dtype=torch.float32,
                                device="cpu").model.state_dict()
    v = i3d_torch_to_flax(sd)
    rng = np.random.RandomState(seed + 1)
    return {"params": randomize_bn(v["params"], rng),
            "batch_stats": randomize_bn(v["batch_stats"], rng)}
