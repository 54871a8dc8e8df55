"""Dense 478-point FaceMesh-topology landmarker and its procedural face
renderer, on the card.

Own copy of ``stdd_tpu/models/facemesh.py``. The reference runs MediaPipe
FaceMesh per track; its weights are not obtainable, so the JAX package
ships a landmarker distilled from a procedural face model
(``stdd_tpu/assets/landmarker.pkl``, copied byte for byte to
``stdd_torch/assets/landmarker.pkl``):

- :func:`canonical_mesh` — the [478, 2] template in a unit face box, every
  index the feature builders use (``data/features.py`` KEY_LANDMARKS_IDXS,
  MP68_IDX) at its FaceMesh location (numpy, equal to JAX's);
- :func:`deform`, :func:`apply_rigid`, :func:`reconstruct` — the analytic
  6-parameter expression field and the rigid similarity, on tensors;
- :func:`render_faces` — the renderer, one tensor program over the batch
  (the JAX package ``vmap``s :func:`render_one`): parameters in,
  ``[B, S, S, 3]`` images out, with exact landmark ground truth from the
  same field;
- :func:`sample_params`, :func:`sample_holdout_params`,
  :func:`augment_renders` — training draws from an explicit
  ``torch.Generator`` (their ranges and held-out bands are JAX's; the draws
  cannot be ``jax.random``'s);
- :class:`LandmarkNet` — the CNN regressing (rigid, theta) from a 128² crop,
  with flax's defaults written out (tanh-approximate GELU, ``SAME`` padding
  that pads a stride-2 conv of an even side by (0, 1));
- :class:`DenseLandmarker` — the ``(frame_rgb, tlbr) -> [478, 2]`` callable
  ``data/preprocess.py`` plugs in, on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# canonical template
# ---------------------------------------------------------------------------

N_POINTS = 478
THETA_DIM = 6          # blink_l, blink_r, brow_l, brow_r, mouth_open, smile
RIGID_DIM = 4          # log_scale, rotation, tx, ty  (crop-normalized)

# dense-topology indices of the detector's 5 landmarks (MediaPipe topology):
# iris centers 468/473, nose tip 1, mouth corners 61/291
LM5_DENSE_IDX = (468, 473, 1, 61, 291)
# Landmark-quality sentinel threshold: the JAX package measured 0.086 mean
# box-relative disagreement between this landmarker and YuNet's real
# weights on rendered faces (tests/test_facemesh.py::
# test_dense_landmarker_agrees_with_yunet_real_weights); bound = that + slack.
LM5_AGREEMENT_BOUND = 0.15


def lm5_agreement(pts: np.ndarray, lm5: np.ndarray, box_w: float) -> float:
    """Box-relative disagreement between dense landmarks ``pts`` [478,2] and
    a detector's 5-point set ``lm5`` [5,2] (YuNet order: eye, eye, nose tip,
    mouth corner, mouth corner — both in the same pixel coordinates).
    Eye and mouth pairs are matched order-free. Returns the mean over the
    three groups, normalized by ``box_w`` (the detection box width)."""
    pts = np.asarray(pts, np.float32)
    lm5 = np.asarray(lm5, np.float32)

    def pair(a2, b2):
        d1 = np.linalg.norm(a2[0] - b2[0]) + np.linalg.norm(a2[1] - b2[1])
        d2 = np.linalg.norm(a2[0] - b2[1]) + np.linalg.norm(a2[1] - b2[0])
        return min(d1, d2) / 2.0

    i0, i1, nose, m0, m1 = LM5_DENSE_IDX
    err = (pair(pts[[i0, i1]], lm5[:2]) + pair(pts[[m0, m1]], lm5[3:5])
           + float(np.linalg.norm(pts[nose] - lm5[2])))
    return float(err / (3.0 * max(float(box_w), 1e-6)))


# face layout constants (unit box, x right / y down, frontal face)
_OVAL_C = (0.50, 0.54)
_OVAL_R = (0.36, 0.45)
_EYE_L_C = (0.335, 0.445)     # image-left eye (FaceMesh 33-ring)
_EYE_R_C = (0.665, 0.445)     # image-right eye (FaceMesh 263-ring)
_EYE_HW, _EYE_HH = 0.085, 0.034
_BROW_DY = -0.085             # brow center line above eye center
_MOUTH_C = (0.50, 0.745)
_MOUTH_HW = 0.105             # outer half-width
_MOUTH_IHW = 0.082            # inner half-width
_LIP_TH = 0.030               # outer lip vertical thickness

# MediaPipe FaceMesh index groups (topology only — the coordinates are ours).
# Eye rings: outer corner, lower lid outer→inner, inner corner, upper lid
# inner→outer (the order KEY_LANDMARKS_IDXS lists them in).
_EYE_L_RING = [33, 7, 163, 144, 145, 153, 154, 155, 133,
               173, 157, 158, 159, 160, 161, 246]
_EYE_R_RING = [263, 249, 390, 373, 374, 380, 381, 382, 362,
               398, 384, 385, 386, 387, 388, 466]
# brows: upper line outer→inner, then lower line inner→outer
_BROW_L = [70, 63, 105, 66, 107, 55, 65, 52, 53, 46]
_BROW_R = [300, 293, 334, 296, 336, 285, 295, 282, 283, 276]
# outer lips: left corner, lower arc left→right, right corner (KEY list),
# plus the upper outer arc (left→right)
_LIP_OUT_LOWER = [61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291]
_LIP_OUT_UPPER = [185, 40, 39, 37, 0, 267, 269, 270, 409]
# inner lips: corners 78/308, lower arc and upper arc (left→right)
_LIP_IN_LOWER = [78, 95, 88, 178, 87, 14, 317, 402, 318, 324, 308]
_LIP_IN_UPPER = [191, 80, 81, 82, 13, 312, 311, 310, 415]
# nose bridge top→bottom then below-tip
_NOSE_LINE = [(168, 0.400), (6, 0.445), (197, 0.495), (195, 0.530),
              (5, 0.565), (4, 0.600), (1, 0.620), (19, 0.660), (94, 0.680)]
# full FaceMesh face oval, clockwise from the top (36 points)
_FACE_OVAL = [10, 338, 297, 332, 284, 251, 389, 356, 454, 323, 361, 288,
              397, 365, 379, 378, 400, 377, 152, 148, 176, 149, 150, 136,
              172, 58, 132, 93, 234, 127, 162, 21, 54, 103, 67, 109]
# irises: center + 4-point ring (right iris block first in MediaPipe)
_IRIS_L = [468, 469, 470, 471, 472]
_IRIS_R = [473, 474, 475, 476, 477]


def _eye_ring(cx: float, cy: float, mirror: bool) -> np.ndarray:
    """16-point almond ring in the KEY_LANDMARKS order (see _EYE_L_RING)."""
    pts = np.zeros((16, 2), np.float32)
    sgn = -1.0 if mirror else 1.0          # mirror: outer corner on the right
    outer = (cx - sgn * _EYE_HW, cy)
    inner = (cx + sgn * _EYE_HW, cy)
    pts[0] = outer
    pts[8] = inner
    for i, t in enumerate(np.linspace(0.125, 0.875, 7)):     # lower lid outer→inner
        x = outer[0] + (inner[0] - outer[0]) * t
        pts[1 + i] = (x, cy + _EYE_HH * math.sin(math.pi * t))
    for i, t in enumerate(np.linspace(0.875, 0.125, 7)):     # upper lid inner→outer
        x = outer[0] + (inner[0] - outer[0]) * t
        pts[9 + i] = (x, cy - _EYE_HH * math.sin(math.pi * t))
    return pts


def _brow_arc(cx: float, cy: float, mirror: bool) -> np.ndarray:
    """10-point thin brow loop: upper line outer→inner, lower inner→outer."""
    sgn = -1.0 if mirror else 1.0
    hw = _EYE_HW * 1.25
    pts = np.zeros((10, 2), np.float32)
    for i, t in enumerate(np.linspace(0.0, 1.0, 5)):
        x = cx - sgn * hw + sgn * 2 * hw * t
        pts[i] = (x, cy - 0.016 * math.sin(math.pi * (0.15 + 0.7 * t)) - 0.008)
    for i, t in enumerate(np.linspace(1.0, 0.0, 5)):
        x = cx - sgn * hw + sgn * 2 * hw * t
        pts[5 + i] = (x, cy - 0.016 * math.sin(math.pi * (0.15 + 0.7 * t)) + 0.008)
    return pts


def _lip_arc(half_w: float, y0: float, bow: float, n: int,
             corners: bool = False) -> np.ndarray:
    """Lip arc left→right around _MOUTH_C: y = y0 + bow·sin(pi t)."""
    cx, cy = _MOUTH_C
    ts = np.linspace(0.0, 1.0, n) if corners else np.linspace(
        1.0 / (n + 1), 1.0 - 1.0 / (n + 1), n)
    pts = np.zeros((n, 2), np.float32)
    for i, t in enumerate(ts):
        pts[i] = (cx - half_w + 2 * half_w * t,
                  cy + y0 + bow * math.sin(math.pi * t))
    return pts


def canonical_mesh() -> np.ndarray:
    """[478, 2] canonical template in the unit face box. The indices no
    consumer names sit on concentric rings inside the face oval, so they
    move rigidly (and smoothly under :func:`deform`) with the face."""
    pts = np.full((N_POINTS, 2), -1.0, np.float32)
    assigned = np.zeros((N_POINTS,), bool)

    def put(idx, xy):
        for i, p in zip(idx, np.atleast_2d(np.asarray(xy, np.float32))):
            pts[i] = p
            assigned[i] = True

    put(_EYE_L_RING, _eye_ring(*_EYE_L_C, mirror=False))
    put(_EYE_R_RING, _eye_ring(*_EYE_R_C, mirror=True))
    put(_BROW_L, _brow_arc(_EYE_L_C[0], _EYE_L_C[1] + _BROW_DY, mirror=False))
    put(_BROW_R, _brow_arc(_EYE_R_C[0], _EYE_R_C[1] + _BROW_DY, mirror=True))

    # lips: corners on the outer-lower arc; inner arcs slightly inside
    put(_LIP_OUT_LOWER, _lip_arc(_MOUTH_HW, 0.0, _LIP_TH, 11, corners=True))
    put(_LIP_OUT_UPPER, _lip_arc(_MOUTH_HW * 0.92, 0.0, -_LIP_TH, 9))
    put(_LIP_IN_LOWER, _lip_arc(_MOUTH_IHW, 0.0, _LIP_TH * 0.45, 11, corners=True))
    put(_LIP_IN_UPPER, _lip_arc(_MOUTH_IHW * 0.9, 0.0, -_LIP_TH * 0.45, 9))

    for idx, y in _NOSE_LINE:
        put([idx], [(0.5, y)])
    put([98], [(0.44, 0.655)])          # nose wings
    put([327], [(0.56, 0.655)])

    cx, cy = _OVAL_C
    rx, ry = _OVAL_R
    for k, idx in enumerate(_FACE_OVAL):
        a = 2 * math.pi * k / len(_FACE_OVAL)       # clockwise from the top
        put([idx], [(cx + rx * math.sin(a), cy - ry * math.cos(a))])

    for block, (ecx, ecy) in [(_IRIS_L, _EYE_L_C), (_IRIS_R, _EYE_R_C)]:
        r = _EYE_HH * 0.8
        put([block[0]], [(ecx, ecy)])
        put([block[1]], [(ecx + r, ecy)])
        put([block[2]], [(ecx, ecy - r)])
        put([block[3]], [(ecx - r, ecy)])
        put([block[4]], [(ecx, ecy + r)])

    free = np.where(~assigned)[0]
    n = len(free)
    golden = (1 + 5 ** 0.5) / 2
    for j, idx in enumerate(free):
        rr = math.sqrt((j + 0.5) / n)          # uniform over the disk
        aa = 2 * math.pi * ((j / golden) % 1.0)
        pts[idx] = (cx + 0.92 * rx * rr * math.cos(aa),
                    cy + 0.92 * ry * rr * math.sin(aa))
    return pts


# ---------------------------------------------------------------------------
# analytic deformation field
# ---------------------------------------------------------------------------

def _gauss2(x, y, cx, cy, sx, sy):
    return torch.exp(-(((x - cx) / sx) ** 2 + ((y - cy) / sy) ** 2))


def deform(points: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Apply the 6-parameter expression field to [..., N, 2] points.
    ``theta`` [..., 6] = (blink_l, blink_r ∈ [0,1], brow_l, brow_r ∈ [-1,1],
    mouth_open ∈ [0,1], smile ∈ [-1,1])."""
    x, y = points[..., 0], points[..., 1]
    blink_l, blink_r, brow_l, brow_r, mouth_open, smile = [
        theta[..., i, None] for i in range(THETA_DIM)]
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(y)

    # blink: compress toward the eye center line
    for (ecx, ecy), b in [(_EYE_L_C, blink_l), (_EYE_R_C, blink_r)]:
        w = _gauss2(x, y, ecx, ecy, _EYE_HW * 1.6, _EYE_HH * 3.2)
        dy = dy + b * w * (ecy - y) * 0.85

    # brow raise/lower: vertical shift around the brow line
    for (ecx, ecy), b in [(_EYE_L_C, brow_l), (_EYE_R_C, brow_r)]:
        w = _gauss2(x, y, ecx, ecy + _BROW_DY, _EYE_HW * 1.8, 0.045)
        dy = dy - b * w * 0.030

    # mouth open: points below the mouth midline (and the jaw) drop
    mcx, mcy = _MOUTH_C
    wm = _gauss2(x, y, mcx, mcy, _MOUTH_HW * 2.0, 0.10)
    below = torch.sigmoid((y - mcy) / 0.012)
    dy = dy + mouth_open * (0.060 * wm * below
                            + 0.025 * torch.sigmoid((y - 0.88) / 0.03))

    # smile: corners out and up
    for sgn in (-1.0, 1.0):
        ccx = mcx + sgn * _MOUTH_HW
        w = _gauss2(x, y, ccx, mcy, 0.055, 0.055)
        dx = dx + smile * w * sgn * 0.030
        dy = dy - smile * w * 0.022

    return torch.stack([x + dx, y + dy], dim=-1)


def apply_rigid(points: torch.Tensor, rigid: torch.Tensor) -> torch.Tensor:
    """Similarity transform of [..., N, 2] unit-box points into crop-
    normalized coordinates. ``rigid`` = (log_scale, rot, tx, ty): the face
    box center (0.5, 0.55) maps to (0.5+tx, 0.55+ty), scaled by
    exp(log_scale) and rolled by ``rot`` radians."""
    ls, rot, tx, ty = [rigid[..., i, None] for i in range(RIGID_DIM)]
    s = torch.exp(ls)
    # the JAX package's centre is a float32 constant, in float64 runs too
    c0 = torch.tensor([0.5, 0.55], dtype=torch.float32).to(points.device, points.dtype)
    p = points - c0
    ca, sa = torch.cos(rot), torch.sin(rot)
    xr = ca * p[..., 0] - sa * p[..., 1]
    yr = sa * p[..., 0] + ca * p[..., 1]
    out = torch.stack([xr, yr], dim=-1) * s[..., None]
    return out + (c0 + torch.cat([tx, ty], dim=-1))[..., None, :]


def reconstruct(canon: torch.Tensor, rigid: torch.Tensor,
                theta: torch.Tensor) -> torch.Tensor:
    """rigid ∘ deform(canonical, theta): [..., 478, 2] crop-normalized."""
    return apply_rigid(deform(canon, theta), rigid)


# ---------------------------------------------------------------------------
# renderer (training data generator), batched over B
# ---------------------------------------------------------------------------

def _soft_ellipse(x, y, cx, cy, rx, ry, soft=0.015):
    d = torch.sqrt(((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2)
    return torch.sigmoid((1.0 - d) / soft)


def _rgb(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def render_one(rigid: torch.Tensor, theta: torch.Tensor, style: torch.Tensor,
               size: int = 128) -> torch.Tensor:
    """One procedural face → [size, size, 3] in [0, 1] (``render_faces`` of
    a batch of one)."""
    return render_faces(rigid[None], theta[None], style[None], size=size)[0]


def render_faces(rigid: torch.Tensor, theta: torch.Tensor, style: torch.Tensor,
                 generator: Optional[torch.Generator] = None, size: int = 128) -> torch.Tensor:
    """[B] parameter batches → [B, size, size, 3] images in [0, 1], on the
    parameters' device. ``style`` [B, 8]: skin RGB jitter (3), background
    RGB (3), lighting slope (1), lip darkness (1). The drawing geometry
    comes from the same deform field as the landmarks. With ``generator``,
    pixel noise of σ 0.03 is added (the JAX ``key=``)."""
    dt, dev = rigid.dtype, rigid.device
    ii = (torch.arange(size, dtype=dt, device=dev) + 0.5) / size
    py, px = torch.meshgrid(ii, ii, indexing="ij")                # [S, S]

    def col(t, i):                                                # [B] → [B, 1, 1]
        return t[:, i, None, None]

    # inverse rigid: pixel → canonical face space
    s = torch.exp(col(rigid, 0))
    rot = col(rigid, 1)
    cx0, cy0 = 0.5, 0.55
    ux = px - (cx0 + col(rigid, 2))
    uy = py - (cy0 + col(rigid, 3))
    ca, sa = torch.cos(-rot), torch.sin(-rot)
    x = (ca * ux - sa * uy) / s + cx0                             # [B, S, S]
    y = (sa * ux + ca * uy) / s + cy0

    blink_l, blink_r, brow_l, brow_r, mouth_open, smile = [col(theta, i) for i in range(THETA_DIM)]
    skin = torch.clamp(_rgb([0.78, 0.62, 0.52], rigid) + style[:, :3] * 0.18, 0.15, 0.95)
    bg = torch.clamp(0.5 + style[:, 3:6] * 0.5, 0.0, 1.0)
    light = 1.0 + col(style, 6) * 0.35 * (x - 0.5) + 0.15 * col(style, 7) * (y - 0.5)

    img = torch.ones((x.shape[0], size, size, 3), dtype=dt, device=dev) * bg[:, None, None, :]
    face = _soft_ellipse(x, y, *_OVAL_C, *_OVAL_R)[..., None]
    img = img * (1 - face) + face * (skin[:, None, None, :] * light[..., None])

    # brows (deformed line): dark soft bars at the shifted brow height
    for (ecx, ecy), b in [(_EYE_L_C, brow_l), (_EYE_R_C, brow_r)]:
        by = ecy + _BROW_DY - b * 0.030
        m = _soft_ellipse(x, y, ecx, by, _EYE_HW * 1.25, 0.012, soft=0.02)
        img = img * (1 - 0.75 * m[..., None] * _rgb([1.0, 1.0, 1.0], rigid))

    # eyes: sclera aperture shrinks with blink, iris disk, lid = skin
    for (ecx, ecy), b in [(_EYE_L_C, blink_l), (_EYE_R_C, blink_r)]:
        ap = _EYE_HH * (1.0 - 0.92 * b)
        sclera = _soft_ellipse(x, y, ecx, ecy, _EYE_HW, ap, soft=0.008)[..., None]
        iris = _soft_ellipse(x, y, ecx, ecy, _EYE_HH * 0.75,
                             torch.clamp(ap, max=_EYE_HH * 0.75), soft=0.006)[..., None]
        img = img * (1 - sclera) + sclera * _rgb([0.93, 0.93, 0.92], rigid)
        img = img * (1 - iris) + iris * _rgb([0.18, 0.12, 0.10], rigid)

    # nose shading: a faint vertical ridge + nostril dots
    ridge = _gauss2(x, y, 0.5, 0.53, 0.018, 0.09)
    img = img * (1 - 0.12 * ridge[..., None])
    for nx in (0.46, 0.54):
        nd = _soft_ellipse(x, y, nx, 0.645, 0.012, 0.008, soft=0.006)
        img = img * (1 - 0.45 * nd[..., None])

    # mouth: outer lips ring + dark opening; corners follow the smile field
    mcx, mcy = _MOUTH_C
    m_hw = _MOUTH_HW * (1.0 + 0.28 * smile)
    lip_cy = mcy + mouth_open * 0.030 - smile * 0.010
    open_h = 0.004 + mouth_open * 0.042
    lips = _soft_ellipse(x, y, mcx, lip_cy, m_hw, _LIP_TH + open_h, soft=0.010)[..., None]
    lip_col = _rgb([0.62, 0.28, 0.26], rigid) * (0.7 + 0.3 * style[:, 7, None])
    img = img * (1 - lips * 0.85) + lips * 0.85 * lip_col[:, None, None, :]
    opening = _soft_ellipse(x, y, mcx, lip_cy, m_hw * 0.8, open_h, soft=0.006)
    img = img * (1 - opening[..., None] * 0.9)
    img = torch.clamp(img, 0.0, 1.0)

    if generator is not None:
        noise = torch.randn(img.shape, generator=generator, dtype=dt, device=generator.device)
        img = torch.clamp(img + 0.03 * noise.to(dev), 0.0, 1.0)
    return img


# Held-out style families: two parameter bands the trainer excludes
# (``sample_params(exclude_holdout=True)``) so off-domain generalization
# within the procedural family is measurable.
HOLDOUT_ROT = (0.34, 0.50)       # rigid[1]: in-plane roll (radians)
HOLDOUT_LIGHT = (0.70, 1.00)     # style[6]: horizontal lighting slope


def _uniform(g: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0, device=None):
    u = torch.rand(shape, generator=g, device=g.device)
    return (lo + (hi - lo) * u).to(device if device is not None else g.device)


def sample_params(generator: torch.Generator, batch: int, exclude_holdout: bool = False,
                  device=None):
    """Random (rigid [B,4], theta [B,6], style [B,8]) batches for training,
    in JAX's ranges. ``exclude_holdout=True`` draws rot / lighting strictly
    below the held-out bands; :func:`sample_holdout_params` draws inside
    them."""
    g = generator
    ls = _uniform(g, (batch, 1), -0.45, 0.25, device)
    rot_hi = HOLDOUT_ROT[0] if exclude_holdout else 0.5
    rot = _uniform(g, (batch, 1), -0.5, rot_hi, device)
    txy = _uniform(g, (batch, 2), -0.10, 0.10, device)
    rigid = torch.cat([ls, rot, txy], dim=1)
    blink = _uniform(g, (batch, 2), device=device) ** 2          # mostly open
    brows = _uniform(g, (batch, 2), -1.0, 1.0, device)
    mo_sm = _uniform(g, (batch, 2), 0.0, 1.0, device)
    theta = torch.cat([blink, brows, mo_sm[:, :1], mo_sm[:, 1:] * 2.0 - 1.0], dim=1)
    style = _uniform(g, (batch, 8), -1.0, 1.0, device)
    if exclude_holdout:
        style[:, 6] = _uniform(g, (batch,), -1.0, HOLDOUT_LIGHT[0], device)
    return rigid, theta, style


def sample_holdout_params(generator: torch.Generator, batch: int, device=None):
    """Parameter batches inside the held-out bands (roll and lighting both
    out of the training domain): the generalization eval set."""
    rigid, theta, style = sample_params(generator, batch, device=device)
    rigid[:, 1] = _uniform(generator, (batch,), *HOLDOUT_ROT, device)
    style[:, 6] = _uniform(generator, (batch,), *HOLDOUT_LIGHT, device)
    return rigid, theta, style


def augment_renders(generator: torch.Generator, imgs: torch.Tensor) -> torch.Tensor:
    """Label-preserving domain randomization of [B, S, S, 3] renders: a
    directional lighting gradient, two clutter/occluder rectangles (each
    drawn with probability 1/2, random size, colour and 0.85 alpha) and
    pixel noise of σ 0.04, clipped to [0, 1]."""
    g, dev = generator, imgs.device
    B, S = imgs.shape[0], imgs.shape[1]
    ii = (torch.arange(S, dtype=imgs.dtype, device=dev) + 0.5) / S
    yy, xx = torch.meshgrid(ii, ii, indexing="ij")

    ang = _uniform(g, (B, 1, 1), 0.0, 2 * math.pi, dev)
    gain = _uniform(g, (B, 1, 1), 0.0, 0.5, dev)
    grad = 1.0 + gain * 2.0 * (torch.cos(ang) * (xx - 0.5) + torch.sin(ang) * (yy - 0.5))
    imgs = imgs * grad[..., None]

    for _ in range(2):
        cx = _uniform(g, (B, 1, 1), device=dev)
        cy = _uniform(g, (B, 1, 1), device=dev)
        hw = _uniform(g, (B, 1, 1), 0.03, 0.14, dev)
        hh = _uniform(g, (B, 1, 1), 0.03, 0.14, dev)
        colour = _uniform(g, (B, 1, 1, 3), device=dev)
        on = (_uniform(g, (B, 1, 1), device=dev) < 0.5).to(imgs.dtype)
        inside = ((torch.abs(xx - cx) < hw) & (torch.abs(yy - cy) < hh)).to(imgs.dtype) * on
        alpha = inside[..., None] * 0.85
        imgs = imgs * (1 - alpha) + alpha * colour

    noise = torch.randn(imgs.shape, generator=g, dtype=imgs.dtype, device=g.device).to(dev)
    return torch.clamp(imgs + 0.04 * noise, 0.0, 1.0)


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------

def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax/XLA ``padding="SAME"``: total pad ``max((ceil(n/s)-1)·s + k - n,
    0)`` per side, the smaller half before (a stride-2 3×3 conv of an even
    side pads (0, 1))."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _SameConv(nn.Conv2d):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride=stride, padding=0)

    def forward(self, x):
        return super().forward(_same_pad(x, 3, self.stride[0]))


class LandmarkNet(nn.Module):
    """128² crop → (rigid [B, 4], theta [B, 6]); ~1.1 M parameters. Outputs
    are squashed to the training parameter ranges. Takes ``[B, 128, 128, 3]``
    in [0, 1] (channels last, as the JAX net) and runs NCHW inside."""

    def __init__(self, width: int = 32):
        super().__init__()
        w = width
        chans = [w, w * 2, w * 4, w * 8, w * 8]
        cin = 3
        for i, ch in enumerate(chans):
            setattr(self, f"c{i}", _SameConv(cin, ch, stride=2))
            setattr(self, f"c{i}b", _SameConv(ch, ch))
            cin = ch
        self.n_stages = len(chans)
        self.fc = nn.Linear(cin, 256)
        self.head = nn.Linear(256, RIGID_DIM + THETA_DIM)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = (x - 0.5).permute(0, 3, 1, 2)
        for i in range(self.n_stages):
            x = F.gelu(getattr(self, f"c{i}")(x), approximate="tanh")
            x = F.gelu(getattr(self, f"c{i}b")(x), approximate="tanh")
        x = x.mean(dim=(2, 3))
        x = F.gelu(self.fc(x), approximate="tanh")
        t = torch.tanh(self.head(x))
        rigid = torch.cat([
            t[:, 0:1] * 0.45 - 0.10,            # log_scale ∈ [-0.55, 0.35]
            t[:, 1:2] * 0.55,                   # rot
            t[:, 2:4] * 0.12,                   # tx, ty
        ], dim=1)
        theta = torch.cat([
            (t[:, 4:6] + 1.0) * 0.5,            # blinks ∈ [0, 1]
            t[:, 6:8],                          # brows ∈ [-1, 1]
            (t[:, 8:9] + 1.0) * 0.5,            # mouth_open ∈ [0, 1]
            t[:, 9:10],                         # smile ∈ [-1, 1]
        ], dim=1)
        return rigid, theta


@torch.no_grad()
def flax_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initializers, in place: every conv and dense kernel
    from ``lecun_normal`` (a normal truncated at ±2σ, scaled to variance
    1/fan_in), every bias zero. The draws are torch's, not JAX's."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
            m.weight.copy_(w * std)
            m.bias.zero_()
    return net


# ---------------------------------------------------------------------------
# pluggable landmarker
# ---------------------------------------------------------------------------

class DenseLandmarker:
    """``(frame_rgb, tlbr) -> [478, 2]`` frame-coordinate landmarker.

    Crops a 1.3× square around the track box on the host (zero-padded at
    the borders), resizes it to 128 (cv2's INTER_LINEAR sample positions;
    ``models/yunet.py::resize_linear_u8``), runs :class:`LandmarkNet` on
    ``device``, reconstructs the dense mesh and maps it back to frame
    coordinates. ``variables`` is the flax tree (``{"params": ...}`` of
    numpy arrays) that both packages pickle."""

    CROP = 128

    def __init__(self, variables=None, seed: int = 0, device="cuda"):
        from ..utils.weights import flax_to_torch

        self.device = torch.device(device)
        self.net = LandmarkNet()
        if variables is None:
            flax_init_(self.net, torch.Generator().manual_seed(seed))
        else:
            self.net.load_state_dict(flax_to_torch(variables, self.net, "landmarker"))
        self.net.to(self.device).eval()
        self._canon = torch.from_numpy(canonical_mesh()).to(self.device)

    @property
    def variables(self):
        from ..utils.weights import torch_to_flax

        return torch_to_flax(self.net.state_dict())

    @torch.no_grad()
    def forward(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, 128, 128, 3] in [0, 1] on ``device`` → (crop-normalized dense
        points [B, 478, 2], theta [B, 6])."""
        rigid, theta = self.net(imgs)
        return reconstruct(self._canon, rigid, theta), theta

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda") -> "DenseLandmarker":
        with open(path, "rb") as f:
            variables = pickle.load(f)
        return cls(variables=variables, device=device)

    @classmethod
    def pretrained_path(cls) -> str:
        """Path of the packaged checkpoint (``stdd_torch/assets/landmarker.pkl``,
        a byte-for-byte copy of the JAX package's)."""
        return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "landmarker.pkl")

    @classmethod
    def pretrained(cls, device="cuda") -> "DenseLandmarker":
        """The packaged checkpoint, trained by the JAX package's
        ``train/train_landmarker.py`` on the procedural face domain."""
        return cls.from_checkpoint(cls.pretrained_path(), device=device)

    def save(self, path: str) -> None:
        """Pickle the flax tree of numpy arrays, the layout either package's
        ``from_checkpoint`` reads."""
        with open(path, "wb") as f:
            pickle.dump(self.variables, f)

    def _crop(self, frame_rgb: np.ndarray, tlbr) -> Tuple[np.ndarray, Tuple[float, float, float]]:
        from .yunet import resize_linear_u8

        H, W = frame_rgb.shape[:2]
        x1, y1, x2, y2 = [float(v) for v in tlbr[:4]]
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        size = max(x2 - x1, y2 - y1) * 1.3
        ox, oy = cx - size / 2, cy - size / 2
        xi1, yi1 = int(max(0, ox)), int(max(0, oy))
        xi2, yi2 = int(min(W, ox + size)), int(min(H, oy + size))
        patch = np.zeros((int(size) + 1, int(size) + 1, 3), np.uint8)
        if xi2 > xi1 and yi2 > yi1:
            patch[yi1 - int(oy):yi1 - int(oy) + (yi2 - yi1),
                  xi1 - int(ox):xi1 - int(ox) + (xi2 - xi1)] = frame_rgb[yi1:yi2, xi1:xi2]
        feed = resize_linear_u8(torch.from_numpy(patch), self.CROP, self.CROP).numpy()
        return feed.astype(np.float32) / 255.0, (ox, oy, size)

    def __call__(self, frame_rgb: np.ndarray, tlbr) -> Optional[np.ndarray]:
        feed, (ox, oy, size) = self._crop(frame_rgb, tlbr)
        pts, _ = self.forward(torch.from_numpy(feed[None]).to(self.device))
        pts = pts[0].cpu().numpy()                  # [478, 2] crop-normalized
        return pts * size + np.asarray([ox, oy], np.float32)

    def lm68(self, frame_rgb: np.ndarray, tlbr) -> Optional[np.ndarray]:
        """68-point subset in the reference's MP68 order."""
        from ..data.features import MP68_IDX

        dense = self(frame_rgb, tlbr)
        return None if dense is None else dense[MP68_IDX]
