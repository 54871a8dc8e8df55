"""Frame-quality gating on the host: Laplacian-variance blur metric plus
size/blur weights.

Host functions of ``stdd_tpu/ops/quality.py`` (reference TEST2.py:116
variance_of_laplacian, weight TEST2.py:287 / af_realtime.py:262): RGB→gray
with BT.601 weights rounded to uint8, Laplacian [[0,1,0],[1,-4,1],[0,1,0]],
reflect-101 border, population variance — cv2's semantics. The fused
native path (``stdd_torch/native``) is used when it builds; the numpy twins
compute the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def variance_of_laplacian_np(crop_rgb: np.ndarray) -> float:
    """Blur metric of one RGB crop (matches cv2 to float tolerance)."""
    g = np.floor(
        crop_rgb[..., 0] * 0.299 + crop_rgb[..., 1] * 0.587 + crop_rgb[..., 2] * 0.114
        + 0.5
    )
    p = np.pad(g, 1, mode="reflect")
    lap = (
        p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]
    )
    return float(lap.var())


def frame_quality_weight(
    min_side: float,
    lap_var: float,
    min_size_hard: float = 32,
    min_size_soft: float = 64,
    lap_hard: float = 10.0,
    lap_soft: float = 60.0,
    weighting: bool = True,
) -> float:
    """Hard/soft size+blur gating weight in [0, 1]
    (TEST2.py:287 _frame_quality_weight). 0 drops the frame."""
    if min_side < min_size_hard or lap_var < lap_hard:
        return 0.0
    if not weighting:
        return 1.0
    size_w = (
        1.0
        if min_side >= min_size_soft
        else max(0.0, (min_side - min_size_hard) / max(1.0, min_size_soft - min_size_hard))
    )
    lap_w = (
        1.0
        if lap_var >= lap_soft
        else max(0.0, (lap_var - lap_hard) / max(1e-6, lap_soft - lap_hard))
    )
    return float(size_w * lap_w)


def half_res_area(crop: np.ndarray) -> np.ndarray:
    """2× area downsample (cv2.resize INTER_AREA w//2, h//2) — the reference
    computes its blur metric on the half-res crop (TEST2.py:290)."""
    h, w = crop.shape[:2]
    h2, w2 = max(1, h // 2), max(1, w // 2)
    c = crop[: h2 * 2, : w2 * 2].astype(np.float64)
    if crop.ndim == 3:
        out = c.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
    else:
        out = c.reshape(h2, 2, w2, 2).mean(axis=(1, 3))
    if crop.dtype == np.uint8:
        out = np.floor(out + 0.5).astype(np.uint8)
    return out


def crop_quality(
    crop_rgb: np.ndarray,
    min_size_hard: float = 32,
    min_size_soft: float = 64,
    lap_hard: float = 10.0,
    lap_soft: float = 60.0,
    weighting: bool = True,
) -> Tuple[float, float, float]:
    """af_realtime.py:262: blur measured on the half-res crop;
    → (weight, min_side, lap_var)."""
    if crop_rgb.size == 0:
        return 0.0, 0.0, 0.0
    h, w = crop_rgb.shape[:2]
    min_side = min(h, w)
    if min_side < 4:
        # degenerate sliver: far below any min_size gate; the blur metric's
        # numpy/native paths disagree on < 2-pixel sides
        return 0.0, float(min_side), 0.0
    from ..native import crop_lapvar_halfres

    lap = crop_lapvar_halfres(crop_rgb)
    if lap is None:
        lap = variance_of_laplacian_np(half_res_area(crop_rgb))
    wq = frame_quality_weight(
        min_side, lap, min_size_hard, min_size_soft, lap_hard, lap_soft, weighting
    )
    return wq, float(min_side), float(lap)
