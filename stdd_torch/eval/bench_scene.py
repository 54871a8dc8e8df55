"""Synthetic multi-face call scene of rendered talking heads.

Own copy of ``stdd_tpu/eval/bench_scene.py``: faces drawn by the procedural
renderer the packaged landmarker was trained on
(``models/facemesh.py::render_faces``) are composited into the frame and
drift across it. Everything is rendered once at construction (a K-frame
talking loop per face, rendered on the card in chunks of 8 at 128²); per
frame the work is a background restore and sprite pastes.

The JAX scene's cv2 calls are written in numpy: the sprites' INTER_LINEAR
upscale (``models/yunet.py::resize_linear_u8``) and the background's
INTER_CUBIC field (:func:`resize_cubic_f32`). :meth:`BenchScene.detect`
runs ``detect_scaled`` at 320 as the JAX scene does; :meth:`BenchScene.oracle`
gives the rows a detector would ideally return, from the renderer's own
mesh: the stand-in for YuNet's weights, which are not in the repository.
"""

from __future__ import annotations

import numpy as np
import torch

_RENDER_CHUNK = 8          # fixed render batch
_RENDER_SIZE = 128         # native renderer resolution (upscaled at paste)
_CUBIC_A = -0.75           # cv2's bicubic coefficient


def _cubic_taps(out_n: int, in_n: int):
    """cv2 INTER_CUBIC along one axis: source taps [out, 4] (edge clamped)
    and their weights [out, 4] in float32."""
    f = (np.arange(out_n, dtype=np.float64) + 0.5) * (in_n / out_n) - 0.5
    s = np.floor(f)
    x = (f - s).astype(np.float32)[:, None]
    a = np.float32(_CUBIC_A)
    x1 = x + 1
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    y = 1 - x
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    c3 = 1 - c0 - c1 - c2
    taps = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :], 0, in_n - 1)
    return taps, np.concatenate([c0, c1, c2, c3], axis=1).astype(np.float32)


def resize_cubic_f32(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(a, (w, h), interpolation=cv2.INTER_CUBIC)`` of a 2D
    float32 array: cv2's sample positions, its a = −0.75 kernel and
    replicated edges, horizontal pass first, in float32."""
    tx, wx = _cubic_taps(w, a.shape[1])
    ty, wy = _cubic_taps(h, a.shape[0])
    rows = (a[:, tx] * wx[None]).sum(axis=2, dtype=np.float32)       # [h0, w]
    return (rows[ty] * wy[:, :, None]).sum(axis=1, dtype=np.float32)  # [h, w]


class BenchScene:
    """Deterministic talking-heads scene.

    ``frame(i)`` returns the BGR uint8 frame for global frame index ``i``;
    ``detect(det, frame)`` runs ``detect_scaled`` at 320 and returns the
    raw [N, 15] rows; ``oracle(i)`` returns the rows of the faces as drawn.
    The sprites are rendered on ``device`` (the card unless told
    otherwise)."""

    def __init__(self, frame_hw, n_faces: int = 1, seed: int = 0,
                 face_px: int = 288, loop: int = 24, expr_order=None, device="cuda"):
        from ..models.facemesh import canonical_mesh, reconstruct, render_faces
        from ..models.yunet import resize_linear_u8

        H, W = frame_hw
        self.frame_hw = frame_hw
        self.n_faces = n_faces
        m = 40
        cols = int(np.ceil(np.sqrt(n_faces)))
        rows_n = int(np.ceil(n_faces / cols))
        # clamp so the face grid fits small frames
        face_px = min(face_px, (H - 2 * m) // rows_n, (W - 2 * m) // cols)
        self.face_px = face_px
        self.loop = loop
        rng = np.random.RandomState(seed)

        # --- talking-loop parameters: fixed style per face, theta animated.
        # Skin stays on the natural manifold (brightness × warmth, keeping
        # the renderer's R>G>B base hue), which YuNet's real weights need.
        phase = rng.uniform(0, 2 * np.pi, n_faces)
        styles = np.zeros((n_faces, 8), np.float32)
        bright = rng.uniform(-0.5, 0.45, n_faces)
        warmth = rng.uniform(0.0, 0.4, n_faces)
        styles[:, 0] = bright + 0.3 * warmth
        styles[:, 1] = bright
        styles[:, 2] = bright - 0.3 * warmth
        styles[:, 3:6] = rng.uniform(-0.6, 0.6, (n_faces, 3))   # background
        styles[:, 6] = rng.uniform(-0.3, 0.3, n_faces)          # lighting
        styles[:, 7] = rng.uniform(-0.4, 0.4, n_faces)          # lip tone
        rigid = np.zeros((n_faces, loop, 4), np.float32)
        rigid[..., 1] = 0.05 * np.sin(
            2 * np.pi * np.arange(loop) / loop + phase[:, None])  # head sway
        theta = np.zeros((n_faces, loop, 6), np.float32)
        t = 2 * np.pi * np.arange(loop) / loop
        theta[..., 4] = 0.35 + 0.35 * np.sin(t + phase[:, None])  # mouth_open
        theta[..., 5] = 0.25 * np.sin(0.5 * t + phase[:, None])   # smile
        theta[..., 2] = 0.2 * np.sin(t[None] * 2 + phase[:, None])  # brow_l
        theta[..., 3] = theta[..., 2]

        # --- render on the card in fixed chunks, fetch once ---------------
        flat_r = rigid.reshape(-1, 4)
        flat_t = theta.reshape(-1, 6)
        flat_s = np.repeat(styles, loop, axis=0)
        n = flat_r.shape[0]
        tiles = []
        with torch.no_grad():
            for c in range(0, n, _RENDER_CHUNK):
                sl = slice(c, c + _RENDER_CHUNK)
                tiles.append(render_faces(
                    torch.from_numpy(flat_r[sl]).to(device), torch.from_numpy(flat_t[sl]).to(device),
                    torch.from_numpy(flat_s[sl]).to(device), size=_RENDER_SIZE).cpu().numpy())
            # the renderer's mesh of every sprite, crop-normalized, for oracle()
            self._mesh = reconstruct(torch.from_numpy(canonical_mesh()),
                                     torch.from_numpy(flat_r), torch.from_numpy(flat_t)
                                     ).numpy().reshape(n_faces, loop, -1, 2)
        tiles = np.concatenate(tiles)                      # [F*loop, 128, 128, 3]
        tiles = (tiles * 255).astype(np.uint8)[..., ::-1]  # RGB → BGR, truncating
        sprites = resize_linear_u8(
            torch.from_numpy(np.ascontiguousarray(tiles.transpose(1, 2, 0, 3)).reshape(
                _RENDER_SIZE, _RENDER_SIZE, -1)), face_px, face_px).numpy()
        self.sprites = np.ascontiguousarray(
            sprites.reshape(face_px, face_px, n, 3).transpose(2, 0, 1, 3)
        ).reshape(n_faces, loop, face_px, face_px, 3)

        # --- static background: smooth gradient + low-frequency clutter ----
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        bg = 90 + 50 * xx / W + 30 * yy / H
        low = resize_cubic_f32(rng.uniform(-25, 25, (18, 32)).astype(np.float32), H, W)
        self.bg = np.clip(bg[..., None] + low[..., None]
                          + rng.uniform(-12, 12, 3), 0, 255).astype(np.uint8)
        self.bg = np.ascontiguousarray(np.broadcast_to(self.bg, (H, W, 3)))

        # --- motion: grid starts, slow drift, bounce at margins ------------
        self.pos0 = np.empty((n_faces, 2), np.float64)
        for f in range(n_faces):
            cx = (f % cols + 0.5) / cols * (W - face_px - 2 * m) + m
            cy = (f // cols + 0.5) / rows_n * (H - face_px - 2 * m) + m
            self.pos0[f] = (cx, cy)
        self.vel = rng.uniform(-1.8, 1.8, (n_faces, 2))
        self.lo = np.array([m, m], np.float64)
        self.hi = np.array([W - face_px - m, H - face_px - m], np.float64)

        # --- reusable canvas pool: frame() restores the previous sprites'
        # rects from the background and pastes the new ones, instead of
        # copying the whole frame. A returned frame stays valid for the next
        # _N_CANVAS-1 frame() calls.
        self._N_CANVAS = 8
        self._canvases: list = []
        self._dirty: list = []   # per-canvas [(f, y, x)] of stale sprite pastes
        self._call_no = 0

        # Optional temporal scrambling of the talking loop: a permutation of
        # range(loop) applied to the expression index only (head position
        # stays smooth in ``i``)
        if expr_order is None:
            self._expr = np.arange(loop)
        else:
            self._expr = np.asarray(expr_order, np.int64)
            if (self._expr.shape != (loop,)
                    or not np.array_equal(np.sort(self._expr), np.arange(loop))):
                raise ValueError(f"expr_order must be a permutation of range({loop})")

    def _positions(self, i: int) -> np.ndarray:
        # reflective (triangle-wave) bounce, deterministic in i; a degenerate
        # axis (hi <= lo) pins the face at lo
        span = self.hi - self.lo
        ok = span > 1e-9
        raw = self.pos0 - self.lo + self.vel * i
        tri = np.abs((raw / np.where(ok, span, 1.0)) % 2.0 - 1.0)
        return np.where(ok, self.lo + (1.0 - tri) * span, self.lo)

    def frame(self, i: int, copy: bool = False) -> np.ndarray:
        """BGR frame for index ``i`` (content deterministic in ``i``). The
        returned buffer is reused after ``_N_CANVAS - 1`` further calls;
        pass ``copy=True`` for an independent array."""
        px = self.face_px
        pos = self._positions(i).astype(int)
        if len(self._canvases) < self._N_CANVAS:
            self._canvases.append(self.bg.copy())
            self._dirty.append([])
            out = self._canvases[-1]
            dirty = self._dirty[-1]
        else:
            c = self._call_no % self._N_CANVAS
            out, dirty = self._canvases[c], self._dirty[c]
            # restore each stale sprite rect from the background, minus the
            # same face's incoming paste rect
            for (f, y, x) in dirty:
                nx, ny = int(pos[f, 0]), int(pos[f, 1])
                iy0, iy1 = max(y, ny), min(y + px, ny + px)
                ix0, ix1 = max(x, nx), min(x + px, nx + px)
                if iy0 >= iy1 or ix0 >= ix1:          # no overlap: full rect
                    out[y:y + px, x:x + px] = self.bg[y:y + px, x:x + px]
                    continue
                if y < iy0:
                    out[y:iy0, x:x + px] = self.bg[y:iy0, x:x + px]
                if iy1 < y + px:
                    out[iy1:y + px, x:x + px] = self.bg[iy1:y + px, x:x + px]
                if x < ix0:
                    out[iy0:iy1, x:ix0] = self.bg[iy0:iy1, x:ix0]
                if ix1 < x + px:
                    out[iy0:iy1, ix1:x + px] = self.bg[iy0:iy1, ix1:x + px]
            dirty.clear()
        self._call_no += 1
        k = int(self._expr[i % self.loop])
        for f, (x, y) in enumerate(pos):
            out[y:y + px, x:x + px] = self.sprites[f, k]
            dirty.append((f, int(y), int(x)))
        return out.copy() if copy else out

    def mesh(self, i: int) -> np.ndarray:
        """[N, 478, 2] the renderer's dense mesh of each face in frame ``i``,
        in frame pixels (a sprite's crop-normalized point u lands at
        ``origin + u · face_px``)."""
        k = int(self._expr[i % self.loop])
        pos = self._positions(i).astype(int).astype(np.float32)
        return self._mesh[:, k] * self.face_px + pos[:, None, :]

    def oracle(self, i: int) -> np.ndarray:
        """[N, 15] YuNet-layout rows (x, y, w, h, 5×(x, y), score) of frame
        ``i`` from the renderer's own mesh: the box is the mesh's extent,
        the 5 points are ``LM5_DENSE_IDX`` and the score is 1.0."""
        from ..models.facemesh import LM5_DENSE_IDX

        pts = self.mesh(i)
        lo, hi = pts.min(axis=1), pts.max(axis=1)
        lm5 = pts[:, list(LM5_DENSE_IDX)].reshape(len(pts), 10)
        return np.concatenate([lo, hi - lo, lm5, np.ones((len(pts), 1), np.float32)],
                              axis=1).astype(np.float32)

    def detect(self, det, frame_bgr: np.ndarray) -> np.ndarray:
        from ..models.yunet import detect_scaled

        return detect_scaled(det, frame_bgr, det_size=320)
