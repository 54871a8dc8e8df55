"""Constant-velocity Kalman filter over (x, y, a, h) box states — host plane.

Same model as the reference tracker's filter
(``preprocessing/ByteTrack/kalman_filter.py:42``): 8-state
[x, y, a, h, vx, vy, va, vh], measurement = (cx, cy, aspect, height),
uncertainty scaled by box height. Implemented batch-first: every operation
takes ``[N, 8]`` means and ``[N, 8, 8]`` covariances so the whole track pool
advances in one vectorized call (the reference's ``multi_predict`` is the
only vectorized op it has; here everything is).

This runs on host (numpy): the tracker state machine is tiny (≤ dozens of
faces) and inherently sequential per frame; burning a device round-trip per
frame would cost more than the math.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 0.95 chi-square quantiles, N=1..9 d.o.f. (Mahalanobis gating)
CHI2INV95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070,
             6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}

_STD_POS = 1.0 / 20
_STD_VEL = 1.0 / 160

_F = np.eye(8)
for _i in range(4):
    _F[_i, 4 + _i] = 1.0  # dt = 1
_H = np.eye(4, 8)


def initiate(measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """New track state from one (x, y, a, h) measurement → ([8], [8,8])."""
    m = np.asarray(measurement, dtype=float)
    mean = np.concatenate([m, np.zeros(4)])
    h = m[3]
    std = np.array(
        [2 * _STD_POS * h, 2 * _STD_POS * h, 1e-2, 2 * _STD_POS * h,
         10 * _STD_VEL * h, 10 * _STD_VEL * h, 1e-5, 10 * _STD_VEL * h]
    )
    return mean, np.diag(std ** 2)


def predict(means: np.ndarray, covs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Batch predict: means [N,8], covs [N,8,8] → same shapes."""
    h = means[:, 3]
    std = np.stack(
        [_STD_POS * h, _STD_POS * h, np.full_like(h, 1e-2), _STD_POS * h,
         _STD_VEL * h, _STD_VEL * h, np.full_like(h, 1e-5), _STD_VEL * h],
        axis=1,
    )
    motion_cov = np.zeros_like(covs)
    idx = np.arange(8)
    motion_cov[:, idx, idx] = std ** 2
    new_means = means @ _F.T
    new_covs = _F @ covs @ _F.T + motion_cov
    return new_means, new_covs


def project(means: np.ndarray, covs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """State → measurement space: [N,4], [N,4,4] with observation noise."""
    h = means[:, 3]
    std = np.stack(
        [_STD_POS * h, _STD_POS * h, np.full_like(h, 1e-1), _STD_POS * h], axis=1
    )
    proj_mean = means[:, :4]
    proj_cov = covs[:, :4, :4].copy()
    idx = np.arange(4)
    proj_cov[:, idx, idx] += std ** 2
    return proj_mean, proj_cov


def update(
    means: np.ndarray, covs: np.ndarray, measurements: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch correction with (x, y, a, h) measurements [N,4]."""
    proj_mean, proj_cov = project(means, covs)
    # K = P H^T S^{-1}, solved per item (N tiny)
    PHt = covs[:, :, :4]  # since H = [I4 | 0]
    gain = np.linalg.solve(proj_cov.transpose(0, 2, 1), PHt.transpose(0, 2, 1))
    gain = gain.transpose(0, 2, 1)  # [N, 8, 4]
    innovation = measurements - proj_mean
    new_means = means + np.einsum("nij,nj->ni", gain, innovation)
    new_covs = covs - gain @ proj_cov @ gain.transpose(0, 2, 1)
    return new_means, new_covs


def gating_distance(
    mean: np.ndarray,
    cov: np.ndarray,
    measurements: np.ndarray,
    only_position: bool = False,
) -> np.ndarray:
    """Squared Mahalanobis distance of measurements [M,4] to one state."""
    proj_mean, proj_cov = project(mean[None], cov[None])
    pm, pc = proj_mean[0], proj_cov[0]
    if only_position:
        pm, pc = pm[:2], pc[:2, :2]
        measurements = measurements[:, :2]
    d = measurements - pm
    L = np.linalg.cholesky(pc)
    z = np.linalg.solve(L, d.T)
    return np.sum(z * z, axis=0)


def tlwh_to_xyah(tlwh: np.ndarray) -> np.ndarray:
    """(top-left x, y, w, h) → (center x, center y, w/h, h)."""
    r = np.asarray(tlwh, dtype=float).copy()
    r[..., :2] += r[..., 2:] / 2
    r[..., 2] /= r[..., 3]
    return r


def xyah_to_tlwh(xyah: np.ndarray) -> np.ndarray:
    r = np.asarray(xyah, dtype=float).copy()
    r[..., 2] *= r[..., 3]
    r[..., :2] -= r[..., 2:] / 2
    return r
