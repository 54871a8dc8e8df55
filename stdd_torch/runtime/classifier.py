"""Clip-scoring service: I420→RGB → similarity solve → K1 warp → ImageNet
normalize → I3D → sigmoid, on the card.

Port of ``stdd_tpu/runtime/classifier.py``. The JAX scorer jit-compiles the
chain per batch capacity; here it runs eagerly in one CUDA stream. Every
clip takes the K1 kernel (``ops/warp.py``): it is exact for any affine, so
the JAX rotation envelope, its in-graph ``lax.cond`` and the host-side
drift router have no counterpart, and ``path`` arguments are accepted and
ignored. ``score_dense``, ``score_with_features`` and the JAX scorer's
``round_aligned_u8`` and ``score_index`` options (no caller sets them) are
not ported yet; the score is the sigmoid of the first logit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import I3DConfig
from ..models.i3d import I3D, IMAGENET_MEAN, IMAGENET_STD
from ..ops.align import clip_geometry, similarity_cv2, std_points
from ..ops.warp import pack_warp_params, warp_affine
from ..utils.weights import i3d_flax_to_torch


def yuv420_to_rgb(planar: torch.Tensor) -> torch.Tensor:
    """I420 planar frames → float32 RGB, matching cv2's BT.601 video-range
    decode (COLOR_YUV2RGB_I420) with its nearest-neighbour chroma upsample,
    without the final uint8 rounding. ``planar`` [..., S*3//2, S] uint8 →
    [..., S, S, 3] float32 in 0..255."""
    S = planar.shape[-1]
    lead = planar.shape[:-2]
    h = S // 2
    y = planar[..., :S, :].float()

    def chroma(plane):
        c = plane.reshape(lead + (h, 1, h, 1)).float()
        return c.expand(lead + (h, 2, h, 2)).reshape(lead + (S, S)) - 128.0

    u = chroma(planar[..., S:S + S // 4, :])
    v = chroma(planar[..., S + S // 4:, :])
    yl = 1.164 * (y - 16.0)
    r = yl + 1.596 * v
    g = yl - 0.391 * u - 0.813 * v
    b = yl + 2.018 * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


class ProbsHandle:
    """Asynchronous scoring result: ``is_ready()`` polls a CUDA event
    recorded after the device→host copy of the probs; ``np.asarray(handle)``
    waits for it and returns the [B] float32 probs."""

    def __init__(self, probs: torch.Tensor):
        if probs.is_cuda:
            self._host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
            self._host.copy_(probs, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = probs
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a.astype(dtype) if dtype is not None else a


class ClipScorer:
    """Batched scorer over per-track clip buffers.

    ``score(crops, boxes, lm5, valid)``:
      crops [B, T, Hc, Wc, 3] uint8 RGB (zero-padded big-box crops), or
            planar I420 [B, T, S*3//2, S] with ``upload_format="yuv420"``
      boxes [B, T, 4] absolute big-box (x1, y1, x2, y2)
      lm5   [B, T, 5, 2] crop-local 5-point landmarks
      valid [B] bool — padding rows are scored but masked to 0
    → probs [B] float32 (sigmoid of the first logit).

    The model computes in ``dtype`` (bf16 by default) over float32
    parameters, on ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, state_dict, cfg: Optional[I3DConfig] = None,
                 dtype: torch.dtype = torch.bfloat16, upload_format: str = "rgb",
                 device="cuda"):
        self.cfg = cfg or I3DConfig()
        if upload_format not in ("rgb", "yuv420"):
            raise ValueError(f"upload_format must be 'rgb' or 'yuv420', got {upload_format!r}")
        self.upload_format = upload_format
        self.device = torch.device(device)
        self.dtype = dtype
        with torch.device(self.device):
            model = I3D(self.cfg, dtype=dtype)
        model.load_state_dict(state_dict)
        self.model = model.eval().requires_grad_(False)
        self._template = std_points(self.cfg.crop_size, self.device)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)

    # -- construction -------------------------------------------------------

    @classmethod
    def random_init(cls, cfg: Optional[I3DConfig] = None, seed: int = 0, **kw):
        """Scorer over the JAX model's initializers drawn from ``seed``."""
        cfg = cfg or I3DConfig()
        with torch.device("meta"):
            model = I3D(cfg)
        model = model.to_empty(device="cpu")
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return cls(model.state_dict(), cfg=cfg, **kw)

    @classmethod
    def from_flax_variables(cls, variables, cfg: Optional[I3DConfig] = None, **kw):
        """Scorer over a flax variables tree (nested mappings of arrays, e.g.
        ``stdd_tpu``'s ``ClipScorer.variables`` fetched to numpy)."""
        return cls(i3d_flax_to_torch(variables), cfg=cfg, **kw)

    # -- device plumbing ------------------------------------------------------

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        """Host array or tensor → tensor on the scorer's device; host data
        goes through pinned memory so the copy does not block the host."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype=dtype, non_blocking=True)
        a = np.asarray(a)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = a.copy()
        t = torch.from_numpy(a)
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -- the fused scorer -----------------------------------------------------

    def _align_batch(self, crops, boxes, lm5, scale=None, warp=warp_affine):
        """Clip-stable alignment of a [B, T, H, W, 3] batch through K1.
        ``scale`` [B, T]: per-frame crop scales (crops stored pre-scaled,
        geometry unscaled), folded into the packed dst→src affine — exact,
        a similarity absorbs a uniform scale."""
        S = self.cfg.crop_size
        B, T = crops.shape[:2]
        diffs, pts = clip_geometry(boxes, lm5)
        tfm, _ = similarity_cv2(pts.flatten(-3, -2), self._template.repeat(T, 1))
        params = pack_warp_params(tfm, diffs)                  # [B, T, 8]
        if scale is not None:
            params = params * scale[..., None]
        flat = warp(crops.reshape((B * T,) + crops.shape[2:]).contiguous(),
                    params.reshape(B * T, 8).contiguous(), S)
        return flat.reshape(B, T, S, S, 3)

    def _score_impl(self, crops, boxes, lm5, valid, scale=None, warp=warp_affine):
        """Device tensors in, device probs out (``warp`` swaps K1 for its
        plain version when checking the kernel on the card)."""
        with torch.inference_mode():
            # loud format check: a facade that forgot to forward
            # upload_format (packing.upload_format_of) must fail here
            if self.upload_format == "yuv420":
                if crops.dim() != 4:
                    raise ValueError(
                        f"upload_format='yuv420' expects planar I420 crops "
                        f"[B,T,S*3//2,S]; got shape {tuple(crops.shape)} (pack with yuv420=True)")
                crops = yuv420_to_rgb(crops)
            elif crops.dim() != 5:
                raise ValueError(
                    f"upload_format='rgb' expects crops [B,T,H,W,3]; got shape {tuple(crops.shape)}")
            aligned = self._align_batch(crops, boxes.float(), lm5.float(), scale, warp)
            x = (aligned - self._mean) / self._std
            probs = torch.sigmoid(self.model(x)[:, 0].float())
            return torch.where(valid, probs, 0.0)

    # -- public entry points --------------------------------------------------

    def score_async(self, crops, boxes, lm5, valid, path: str = "auto") -> ProbsHandle:
        """Dispatch without blocking; returns a :class:`ProbsHandle`
        (poll ``is_ready()``, materialize with ``np.asarray``). ``path`` is
        accepted for the JAX scorer's signature and ignored: K1 serves
        every clip."""
        probs = self._score_impl(
            self._to_device(crops), self._to_device(boxes, torch.float32),
            self._to_device(lm5, torch.float32), self._to_device(valid, torch.bool))
        return ProbsHandle(probs)

    def score(self, crops, boxes, lm5, valid) -> np.ndarray:
        return np.asarray(self.score_async(crops, boxes, lm5, valid))

    def score_windows(self, windows, boxes, lm5, scale, valid,
                      path: str = "auto") -> ProbsHandle:
        """Score a batch of device-resident ring windows asynchronously.

        ``windows``: list of device tensors, each [T,S,S,3] uint8 RGB (or
        planar I420 [T,S*3//2,S]) already in device memory (DeviceRing
        gathers); only the geometry crosses the host→device boundary.
        Geometry is UNSCALED; the per-frame pack ``scale`` [B, T] is folded
        into the warp."""
        with torch.inference_mode():
            crops = torch.stack(list(windows))
        probs = self._score_impl(
            crops, self._to_device(boxes, torch.float32),
            self._to_device(lm5, torch.float32), self._to_device(valid, torch.bool),
            scale=self._to_device(scale, torch.float32))
        return ProbsHandle(probs)

    def warmup(self, crop_buffer: int, batch_capacities=(1, 2, 4, 8),
               clip_size: Optional[int] = None, windows: bool = False) -> None:
        """Run every batch capacity the engine can dispatch once (K1 builds,
        cuDNN picks its algorithms), so no clip pays that in the hot path.
        ``windows=True`` also runs the ``score_windows`` entry point."""
        T = clip_size or self.cfg.num_frames
        S = crop_buffer
        slot = (T, S * 3 // 2, S) if self.upload_format == "yuv420" else (T, S, S, 3)
        for b in batch_capacities:
            crops = np.zeros((b,) + slot, np.uint8)
            boxes = np.ones((b, T, 4), np.float32)
            lm5 = np.ones((b, T, 5, 2), np.float32)
            valid = np.zeros((b,), bool)
            self.score(crops, boxes, lm5, valid)
            if windows:
                ws = [torch.zeros(slot, dtype=torch.uint8, device=self.device)] * b
                np.asarray(self.score_windows(ws, boxes, lm5, np.ones((b, T), np.float32), valid))
