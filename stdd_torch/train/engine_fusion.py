"""RGB late-fusion training (reference ``dualrun/rgb/engine_rgb.py:424``
train_mmlp, ``fusion.py:413`` train_dual_video, ``csv_alignment.py:85``).

Port of ``stdd_tpu/train/engine_fusion.py``:
- :func:`align_scores` (:27) joins the I3D's per-video scores (the
  harness's ``per_video.csv``) with the dual encoder's per-video scores by
  video key, the file's basename without its extension (so ``real/vid_1``
  and ``fake/vid_1`` share a key, as in JAX);
- :func:`train_moe` (:52) fits the ``GatedMoE`` (``models/dual_rgb.py``) on
  (z_rgb, z_dual, y) with full-batch Adam (``train/optim.py::adam``) and
  BCE on the fused logit.

JAX computes the AUCs with scikit-learn inside one ``try``: where
``roc_auc_score`` raises (a non-finite score; one class in ``y`` in older
releases) that key and every key after it are absent, and scikit-learn
1.9 gives NaN with a warning for one class. The port computes them with
``train/metrics.py::roc_auc`` and leaves out every key whose AUC is
undefined; it never writes NaN.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.dual_rgb import GatedMoE
from .losses import bce_with_logits
from .metrics import np_logit, roc_auc, sigmoid
from .optim import adam


def align_scores(
    rgb_csv_path: str,
    dual_scores: Dict[str, float],
    key_column: str = "video_path",
    score_column: str = "video_score",
    label_column: str = "gt_label",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Join per-video RGB scores (harness CSV) with dual-encoder scores by
    video key → (z_rgb, z_dual, y, keys) in logit space, float32; rows
    without a dual score are left out."""
    z_rgb, z_dual, ys, keys = [], [], [], []
    with open(rgb_csv_path) as f:
        for row in csv.DictReader(f):
            key = os.path.splitext(os.path.basename(row[key_column]))[0]
            if key not in dual_scores:
                continue
            z_rgb.append(np_logit(np.asarray([float(row[score_column])]))[0])
            z_dual.append(np_logit(np.asarray([float(dual_scores[key])]))[0])
            ys.append(int(row[label_column]))
            keys.append(key)
    return (np.asarray(z_rgb, np.float32), np.asarray(z_dual, np.float32),
            np.asarray(ys, np.float32), keys)


def _aucs(y: np.ndarray, scores) -> Dict[str, float]:
    """The AUC keys in order, stopping at the first that is undefined (one
    class in ``y``, or a non-finite score)."""
    out: Dict[str, float] = {}
    if len(np.unique(y)) != 2:
        return out
    for key, s in scores:
        if not np.isfinite(s).all():
            break
        out[key] = roc_auc(y, s)
    return out


def train_moe(
    z_rgb: np.ndarray,
    z_dual: np.ndarray,
    y: np.ndarray,
    epochs: int = 200,
    lr: float = 1e-2,
    seed: int = 0,
    log=print,
    device="cuda",
    init: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict:
    """Fit the gated fusion on per-video logits (engine_rgb.py:424) on
    ``device``: ``GatedMoE`` from ``seed``'s draw, or from ``init`` (a
    state dict), ``epochs`` full-batch Adam steps at ``lr``. Returns its
    ``params`` (a CPU state dict), ``fused_probs`` and ``gates`` [N], and
    the AUC keys as JAX's."""
    model = GatedMoE(seed=seed)
    if init is not None:
        model.load_state_dict(init)
    model.to(device)
    zr = torch.as_tensor(np.asarray(z_rgb, np.float32), device=device)[:, None]
    zd = torch.as_tensor(np.asarray(z_dual, np.float32), device=device)[:, None]
    yy = torch.as_tensor(np.asarray(y, np.float32), device=device)
    params = dict(model.named_parameters())
    names = list(params)
    tx = adam(lr)
    opt = tx.init(params)
    for e in range(epochs):
        z, g = model(zr, zd)
        loss = bce_with_logits(z[:, 0], yy)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        with torch.no_grad():
            updates, opt = tx.update(grads, opt, params)
            for k, p in params.items():
                p.add_(updates[k])
        if (e + 1) % max(1, epochs // 4) == 0:
            log(f"[moe {e + 1}/{epochs}] loss={float(loss.detach()):.4f} "
                f"gate_mean={float(g.detach().mean()):.3f}")

    with torch.no_grad():
        z, g = model(zr, zd)
    fused = torch.sigmoid(z[:, 0]).cpu().numpy()
    out = {"params": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
           "fused_probs": fused, "gates": g[:, 0].cpu().numpy()}
    out.update(_aucs(np.asarray(y), (("auc_fused", fused),
                                     ("auc_rgb", sigmoid(np.asarray(z_rgb))),
                                     ("auc_dual", sigmoid(np.asarray(z_dual))))))
    return out
