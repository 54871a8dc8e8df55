"""Synthetic live-call scene with an oracle face detector.

A JAX-free stand-in for ``stdd_tpu/eval/bench_scene.py`` (which renders its
talking heads with the JAX facemesh renderer and detects them with YuNet,
whose ONNX weights are not in the repository). Here each face is a textured
numpy sprite that drifts across the frame and bounces at the margins, all
deterministic from ``seed``; :meth:`Scene.detect` returns the known face
boxes as YuNet-layout rows (x, y, w, h, 5×(x, y) landmarks, score) with the
landmarks at the alignment template's place inside each box plus a small
per-frame jitter.
"""

from __future__ import annotations

import numpy as np

from ..ops.align import STD_POINTS_256


def _upsample(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable linear upsample of a [h0, w0, C] float array to [h, w, C]."""
    h0, w0 = a.shape[:2]
    yi = np.linspace(0, h0 - 1, h)
    xi = np.linspace(0, w0 - 1, w)
    y0 = np.floor(yi).astype(int).clip(0, h0 - 2)
    x0 = np.floor(xi).astype(int).clip(0, w0 - 2)
    fy = (yi - y0)[:, None, None]
    fx = (xi - x0)[None, :, None]
    rows = a[y0] * (1 - fy) + a[y0 + 1] * fy
    return rows[:, x0] * (1 - fx) + rows[:, x0 + 1] * fx


class Scene:
    """Deterministic moving-faces scene. ``frame(i)`` is the BGR uint8 frame
    of global index ``i``; ``detect(i)`` the oracle's ``[N, 15]`` rows."""

    def __init__(self, frame_hw=(1080, 1920), n_faces: int = 1, seed: int = 0,
                 face_px: int = 288, jitter_px: float = 1.0):
        H, W = frame_hw
        self.frame_hw = frame_hw
        self.n_faces = n_faces
        self.seed = seed
        self.jitter_px = jitter_px
        m = 40
        cols = int(np.ceil(np.sqrt(n_faces)))
        rows_n = int(np.ceil(n_faces / cols))
        face_px = min(face_px, (H - 2 * m) // rows_n, (W - 2 * m) // cols)
        self.face_px = face_px
        rng = np.random.RandomState(seed)

        # background: smooth gradient + low-frequency clutter
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        low = _upsample(rng.uniform(-25, 25, (18, 32, 1)), H, W)
        bg = 90 + 50 * xx / W + 30 * yy / H
        self.bg = np.clip(bg[..., None] + low + rng.uniform(-12, 12, 3), 0, 255
                          ).astype(np.uint8)

        # sprites: a skin-toned ellipse with mid-frequency texture and darker
        # eyes/nose/mouth at the template points, on a textured backdrop
        px = face_px
        yy, xx = np.mgrid[0:px, 0:px].astype(np.float32) / px
        inside = ((xx - 0.5) / 0.36) ** 2 + ((yy - 0.52) / 0.46) ** 2 <= 1.0
        pts = STD_POINTS_256 * (px / 256.0)
        self.sprites = np.empty((n_faces, px, px, 3), np.uint8)
        for f in range(n_faces):
            skin = np.array([150, 170, 210], np.float32) * rng.uniform(0.7, 1.1)  # BGR
            tex = _upsample(rng.uniform(-30, 30, (24, 24, 3)), px, px)
            img = np.where(inside[..., None], skin, rng.uniform(40, 200, 3)) + tex
            for (lx, ly) in pts:
                blob = ((xx * px - lx) ** 2 + (yy * px - ly) ** 2) < (0.035 * px) ** 2
                img[blob] *= 0.35
            self.sprites[f] = np.clip(img, 0, 255).astype(np.uint8)

        # motion: grid starts, slow drift, reflective bounce at the margins
        self.pos0 = np.empty((n_faces, 2), np.float64)
        for f in range(n_faces):
            self.pos0[f] = ((f % cols + 0.5) / cols * (W - px - 2 * m) + m,
                            (f // cols + 0.5) / rows_n * (H - px - 2 * m) + m)
        self.vel = rng.uniform(-1.8, 1.8, (n_faces, 2))
        self.lo = np.array([m, m], np.float64)
        self.hi = np.array([W - px - m, H - px - m], np.float64)

    def _positions(self, i: int) -> np.ndarray:
        span = self.hi - self.lo
        ok = span > 1e-9
        raw = self.pos0 - self.lo + self.vel * i
        tri = np.abs((raw / np.where(ok, span, 1.0)) % 2.0 - 1.0)
        return np.where(ok, self.lo + (1.0 - tri) * span, self.lo).astype(int)

    def frame(self, i: int) -> np.ndarray:
        """BGR frame for index ``i`` (a fresh array; content deterministic in ``i``)."""
        out = self.bg.copy()
        px = self.face_px
        for f, (x, y) in enumerate(self._positions(i)):
            out[y:y + px, x:x + px] = self.sprites[f]
        return out

    def detect(self, i: int) -> np.ndarray:
        """Oracle detections for frame ``i``: ``[n_faces, 15]`` float32 rows
        (x, y, w, h, 5×(x, y) landmarks, score), YuNet's layout."""
        rng = np.random.RandomState((self.seed * 1_000_003 + i) % (2 ** 32))
        px = float(self.face_px)
        rows = []
        for (x, y) in self._positions(i):
            lm = STD_POINTS_256 * (px / 256.0) + np.array([x, y], np.float64)
            lm = lm + rng.uniform(-self.jitter_px, self.jitter_px, lm.shape)
            rows.append([x, y, px, px, *lm.reshape(-1), 0.95])
        return np.asarray(rows, np.float32).reshape(-1, 15)

    def oracle(self, detect_every: int):
        """A ``frame -> rows`` detector for :class:`StreamingEngine`, which
        calls it on frames 0, detect_every, 2·detect_every, … in order (also
        through :class:`AsyncDetector`, whose single worker keeps call
        order). Valid for one engine stepping this scene from frame 0."""
        calls = [0]

        def detect_fn(frame_bgr):
            i = calls[0] * detect_every
            calls[0] += 1
            return self.detect(i)

        return detect_fn
