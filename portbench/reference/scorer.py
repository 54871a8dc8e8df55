"""The plain reference of a served window: I420 → RGB → alignment →
normalisation (float64) → I3D (float32, TF32 off) → logit.

``logits_and_features`` takes windows one at a time, so the reference
holds one clip's activations at once. TF32 is switched off for its
convolutions and products and restored after.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import align, i3d


def logits_and_features(params: Dict[str, torch.Tensor], spec: i3d.NetSpec,
                        windows: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                        eps: float, device) -> Tuple[np.ndarray, np.ndarray]:
    """``windows``: (I420 frames [T, 3S/2, S] uint8, big boxes [T, 4],
    crop-local landmarks [T, 5, 2][, pack scales [T]]) each → (logits
    [N, C], features [N, D]) as float64 numpy."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logits, feats = [], []
    try:
        with torch.no_grad():
            for frames, boxes, lm5, *scale in windows:
                rgb = align.i420_to_rgb(torch.as_tensor(np.asarray(frames) if not
                                                        torch.is_tensor(frames) else frames,
                                                        device=device))
                x = align.normalize(align.align_clip(rgb, boxes, lm5, spec.crop,
                                                     scale[0] if scale else None))
                x = x.float().permute(3, 0, 1, 2)[None]           # [1, 3, T, S, S]
                lg, ft = i3d.forward(params, x, spec, eps)
                logits.append(lg[0].double().cpu().numpy())
                feats.append(ft[0].double().cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return np.stack(logits), np.stack(feats)
