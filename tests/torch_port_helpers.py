"""Shared inputs for the port's parity tests (``tests/test_torch_*.py``).

Both packages get the same numpy arrays: the JAX model's initializers are
drawn once, the BatchNorm statistics and scales are then randomized with a
numpy seed (the JAX init zeroes every block's final BN scale, which would
make each residual branch dead and the parity vacuous), and the tree is
handed as numpy to the JAX side and through the weight bridge to the torch
side.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Optional, Sequence

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


def jax_draws(key, step, y, t0, t1):
    """The SLERP partners [n] and t [n, 1] the JAX dual step
    (``stdd_tpu/train/engine_dual.py``) draws at ``step`` from ``key`` for
    the labels ``y`` [n] (int32), as jax arrays."""
    import jax
    import jax.numpy as jnp

    _, slerp_rng = jax.random.split(jax.random.fold_in(key, step))
    k1, k2 = jax.random.split(slerp_rng)
    n = y.shape[0]
    same = y[:, None] == y[None, :]
    partner = jnp.argmax(jnp.where(same, jax.random.gumbel(k1, (n, n)), -jnp.inf), axis=1)
    t = jax.random.uniform(k2, (n, 1), minval=t0, maxval=t1)
    return partner, t


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


@contextlib.contextmanager
def flax_without_dropout():
    """flax's ``nn.Dropout`` as the identity while the block runs. The JAX
    dual encoder's binary head drops out at a fixed rate of 0.2 whenever it
    trains, and torch cannot draw flax's mask; the step parity runs both
    sides without dropout (the port's ``model.head_dropout = 0``). JAX
    functions traced inside the block keep the identity when called later."""
    import flax.linen as nn
    import pytest

    class Identity(nn.Module):
        rate: float = 0.0
        broadcast_dims: Sequence[int] = ()
        deterministic: Optional[bool] = None
        rng_collection: str = "dropout"

        def __call__(self, inputs, deterministic=None, rng=None):
            return inputs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "Dropout", Identity)
        yield



class Y4mCapture:
    """A stand-in for ``cv2.VideoCapture`` that decodes a ``.y4m`` with the
    port's reader, for feeding the JAX package the port's frames: cv2's own
    ``.y4m`` decode lies up to 3 grey levels from ``cvtColor``, which the
    port matches. ``count`` is what ``CAP_PROP_FRAME_COUNT`` reports."""

    def __init__(self, path, count: float):
        from stdd_torch.utils.video_io import read_y4m

        self._count = count
        self._frames = read_y4m(path)
        self._held = None

    def grab(self):
        self._held = next(self._frames, None)
        return self._held is not None

    def retrieve(self):
        return (self._held is not None), self._held

    def read(self):
        return self.retrieve() if self.grab() else (False, None)

    def get(self, prop):
        import cv2

        assert prop == cv2.CAP_PROP_FRAME_COUNT, prop
        return self._count

    def release(self):
        self._frames = iter(())


def install_y4m_capture(monkeypatch):
    """Patch ``cv2.VideoCapture``, for one test, to a :class:`Y4mCapture`
    whose frame count is cv2's own count of the file."""
    import cv2

    real = cv2.VideoCapture

    def capture(path):
        cap = real(path)
        count = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        cap.release()
        return Y4mCapture(path, count)

    monkeypatch.setattr(cv2, "VideoCapture", capture)


def glyph_table() -> dict:
    """The text tables of ``stdd_torch/utils/draw.py``, rendered with cv2
    here: for each label style and printable ASCII character, the advance
    (``getTextSize`` of the character twice less once), the baseline rows,
    and the coverage bitmap the character alone leaves on a black image in
    white, with its offset from the pen; the style's height."""
    import cv2

    from stdd_torch.utils.draw import TEXT_STYLES, style_key

    out = {}
    chars = [chr(c) for c in range(32, 127)]
    for font, scale, thick in TEXT_STYLES:
        key = style_key(font, scale, thick)
        adv, base, box, covs = [], [], [], []
        for ch in chars:
            (w1, h), b = cv2.getTextSize(ch, font, scale, thick)
            adv.append(cv2.getTextSize(ch * 2, font, scale, thick)[0][0] - w1)
            base.append(b)
            img = np.zeros((160, 160), np.uint8)
            cv2.putText(img, ch, (60, 100), font, scale, 255, thick)
            ys, xs = np.nonzero(img)
            if len(xs):
                y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
                box.append((x0 - 60, y0 - 100, y1 - y0, x1 - x0))
                covs.append(img[y0:y1, x0:x1].reshape(-1))
            else:
                box.append((0, 0, 0, 0))
                covs.append(np.zeros(0, np.uint8))
        out[f"{key}_adv"] = np.asarray(adv, np.int16)
        out[f"{key}_base"] = np.asarray(base, np.int16)
        out[f"{key}_box"] = np.asarray(box, np.int16)
        out[f"{key}_off"] = np.concatenate([[0], np.cumsum([c.size for c in covs])]).astype(np.int32)
        out[f"{key}_cov"] = np.concatenate(covs).astype(np.uint8)
        out[f"{key}_height"] = np.asarray(cv2.getTextSize("A", font, scale, thick)[0][1], np.int16)
    return out


def write_glyph_table(path: Optional[str] = None) -> str:
    """Write :func:`glyph_table` where ``stdd_torch/utils/draw.py`` reads it
    (``python -c "import sys; sys.path[:0] = ['tests', '.']; import
    torch_port_helpers as h; h.write_glyph_table()"`` from the repository's
    root)."""
    from stdd_torch.utils.draw import GLYPHS_PATH

    path = path or GLYPHS_PATH
    np.savez_compressed(path, **glyph_table())
    return path
