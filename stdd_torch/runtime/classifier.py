"""Clip-scoring service: I420→RGB → similarity solve → K1 warp → ImageNet
normalize → I3D → sigmoid, on the card.

Port of ``stdd_tpu/runtime/classifier.py``. The JAX scorer jit-compiles the
chain per batch capacity; here it runs eagerly in one CUDA stream. Every
clip takes the K1 kernel (``ops/warp.py``): it is exact for any affine, so
the JAX rotation envelope, its in-graph ``lax.cond`` and the host-side
drift router have no counterpart, and ``path`` arguments are accepted and
ignored. With ``I3DConfig(fused_s2=True)`` the s2 blocks run K2
(``ops/bottleneck.py``). A ``temporal_only`` config (a trainer sidecar's
``temporal_only: true``) builds the temporal-only I3D, as
``stdd_tpu/runtime/classifier.py:287-293`` does; K2 never runs on its
1×1×1 blocks, K1 still warps every clip. ``int8=True`` (the CLIs'
``--int8``) runs s3-s5 through the int8 convolutions
(``models/i3d.py::int8_conv``) unless the config names its own
``int8_stages``, as ``stdd_tpu/runtime/classifier.py:142-148`` does; it
composes with ``fused_s2`` (K2 keeps s2), ``temporal_only`` (the stages
that exist) and both upload formats. The JAX loader builds that I3D and
not the FTCN, so it refuses the checkpoint ``run_i3d --ftcn`` writes (it
does not cover the model); so does this one by default.

``arch="ftcn_tt"`` serves FTCN-TT instead (``models/ftcn.py::FTCN``: the
temporal-only trunk with the time-transformer head, ``patch_type="time"``),
through the same ``_score_impl`` and every entry point; its config is
forced to ``temporal_only``, ``int8`` takes the stages it has (s3, s4),
``fused_s2`` is refused (K2 computes a 3×3 middle), and
``from_jax_checkpoint(path, arch="ftcn_tt")`` serves what ``run_i3d --ftcn``
writes. The default ``"i3d_ori"`` is the I3D above.

With ``round_aligned_u8`` the aligned clip is rounded to uint8 values
(half to even, as ``jnp.round``) between K1 and the normalize on every
path, as the reference's ``cv2.warpAffine`` on a uint8 canvas quantizes
it; the score is the sigmoid of logit ``score_index``, which must lie in
``[-C, C)`` (JAX's indexing clamps an index outside it silently; this one
raises). The JAX scorer's ``use_pallas_warp``, ``warp_band`` and
``s2d_stem`` have no counterpart: K1 serves every clip, and the I3D
computes the plain stem convolution (``models/i3d.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..config import I3DConfig
from ..models.ftcn import FTCN
from ..models.i3d import I3D, IMAGENET_MEAN, IMAGENET_STD
from ..ops.align import clip_geometry, similarity_cv2, std_points
from ..ops.bottleneck import fused_bottleneck
from ..ops.warp import pack_warp_params, warp_affine
from ..utils.checkpoint import load_checkpoint, tolerant_merge
from ..utils.spans import span
from ..utils.weights import flax_to_torch, i3d_flax_to_torch, i3d_torch_to_flax, torch_to_flax

# the served architectures: AltFreezing's I3D-ResNet50 and FTCN-TT
ARCHS = ("i3d_ori", "ftcn_tt")


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


def sidecar_config(path: str) -> Optional[I3DConfig]:
    """The geometry the trainer wrote beside a checkpoint (``{path}.json``:
    clip_size, crop_size, temporal_only), or None without a sidecar, as
    ``stdd_tpu/runtime/classifier.py:264`` reads it, so a non-224
    checkpoint is never served at 224. A sidecar that is not JSON, or lacks
    ``clip_size`` or ``crop_size`` (the trainer always writes both), raises
    a ``ValueError`` naming it instead of serving a guessed geometry."""
    sidecar = path + ".json"
    try:
        with open(sidecar) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return None
    except json.JSONDecodeError as e:
        raise ValueError(f"checkpoint sidecar {sidecar} is not valid JSON: {e}") from e
    missing = [k for k in ("clip_size", "crop_size") if not isinstance(meta, dict) or k not in meta]
    if missing:
        raise ValueError(f"checkpoint sidecar {sidecar} lacks {missing}: "
                         "the geometry to serve the checkpoint at is unknown")
    return I3DConfig(num_frames=int(meta["clip_size"]), crop_size=int(meta["crop_size"]),
                     temporal_only=bool(meta.get("temporal_only", False)))


def arch_config(arch: str, cfg: Optional[I3DConfig]) -> I3DConfig:
    """The config the scorer builds ``arch`` from: ``cfg`` (default
    ``I3DConfig()``) as it is for ``i3d_ori``, made ``temporal_only`` for
    ``ftcn_tt``, whose 1×1×1 blocks K2 cannot run (``fused_s2`` raises)."""
    cfg = cfg or I3DConfig()
    if arch == "i3d_ori":
        return cfg
    if arch != "ftcn_tt":
        raise ValueError(f"arch must be one of {ARCHS}, got {arch!r}")
    if cfg.fused_s2:
        raise ValueError("fused_s2 runs K2, which computes a 3x3 middle convolution; "
                         "FTCN-TT's blocks are 1x1x1, so arch='ftcn_tt' takes fused_s2=False")
    return dataclasses.replace(cfg, temporal_only=True)


def build_model(arch: str, cfg: I3DConfig, dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The network of ``arch`` over ``arch_config``'s ``cfg``."""
    if arch == "ftcn_tt":
        return FTCN(cfg, patch_type="time", dtype=dtype)
    return I3D(cfg, dtype=dtype)


def load_scorer(ckpt: Optional[str], jax_ckpt: Optional[str], clip_size: int,
                model_crop: Optional[int] = None, arch: str = "i3d_ori", **kw) -> "ClipScorer":
    """The scorer of the serving and evaluation CLIs (``--ckpt``,
    ``--jax_ckpt``, ``--clip_size``, ``--model_crop``, ``--arch``): a
    reference ``.pth``, a trainer checkpoint or, with neither, random
    weights, of the architecture ``arch``. ``--clip_size``
    sets the frames the model takes. A ``--jax_ckpt``'s crop size comes from
    ``--model_crop``, else from its sidecar (with ``temporal_only``), else
    224. The JAX CLIs let the sidecar's clip_size win over ``--clip_size``
    while the engine windows at ``--clip_size`` (ADVICE.md r5 #2,
    ``stdd_tpu/eval/harness.py:945``); the port does not."""
    if ckpt and jax_ckpt:
        raise SystemExit("--ckpt and --jax_ckpt are mutually exclusive")
    cfg = I3DConfig(num_frames=clip_size)
    if ckpt:
        return ClipScorer.from_torch_checkpoint(ckpt, cfg=cfg, arch=arch, **kw)
    if not jax_ckpt:
        return ClipScorer.random_init(cfg=cfg, arch=arch, **kw)
    if model_crop:
        cfg = dataclasses.replace(cfg, crop_size=model_crop)
    else:
        meta = sidecar_config(jax_ckpt)
        if meta is not None:
            cfg = dataclasses.replace(meta, num_frames=clip_size)
    return ClipScorer.from_jax_checkpoint(jax_ckpt, cfg=cfg, arch=arch, **kw)


def _bridges(arch: str):
    """(state dict → flax tree, flax tree → state dict) of ``arch``'s
    weights: the I3D's own bridge, or the zoo's naming rule for the FTCN."""
    if arch == "ftcn_tt":
        return torch_to_flax, lambda v: flax_to_torch(v, what="FTCN")
    return i3d_torch_to_flax, i3d_flax_to_torch


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
    → probs [B] float32 (sigmoid of logit ``score_index``).

    The model (``arch``: ``ARCHS``) computes in ``dtype`` (bf16 by default)
    over float32 parameters, on ``device`` ("cuda" unless the caller asks
    for "cpu"). ``round_aligned_u8``: round the aligned pixels to uint8
    values before the normalize (the reference's quantization). ``int8``:
    the eval-only int8 convolutions for s3-s5 (those the model has) when
    ``cfg`` names no ``int8_stages`` (scores shift by the quantization
    error)."""

    def __init__(self, state_dict, cfg: Optional[I3DConfig] = None,
                 dtype: torch.dtype = torch.bfloat16, score_index: int = 0,
                 round_aligned_u8: bool = False, upload_format: str = "rgb",
                 device="cuda", int8: bool = False, arch: str = "i3d_ori"):
        self.cfg = arch_config(arch, cfg)
        self.arch = arch
        if not -self.cfg.num_classes <= score_index < self.cfg.num_classes:
            raise ValueError(f"score_index {score_index} is out of range for "
                             f"{self.cfg.num_classes} classes")
        self.score_index = score_index
        self.round_aligned_u8 = round_aligned_u8
        if int8 and not self.cfg.int8_stages:
            self.cfg = dataclasses.replace(self.cfg, int8_stages=("s3", "s4", "s5"))
        if upload_format not in ("rgb", "yuv420"):
            raise ValueError(f"upload_format must be 'rgb' or 'yuv420', got {upload_format!r}")
        self.upload_format = upload_format
        self.device = torch.device(device)
        self.dtype = dtype
        with torch.device(self.device):
            model = build_model(arch, self.cfg, dtype)
        model.load_state_dict(state_dict)
        self.model = model.eval().requires_grad_(False)
        self._template = std_points(self.cfg.crop_size, self.device)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)

    # -- construction -------------------------------------------------------

    @classmethod
    def random_init(cls, cfg: Optional[I3DConfig] = None, seed: int = 0,
                    arch: str = "i3d_ori", **kw):
        """Scorer over the JAX model's initializers of ``arch`` drawn from
        ``seed``."""
        cfg = arch_config(arch, cfg)
        with torch.device("meta"):
            model = build_model(arch, cfg)
        model = model.to_empty(device="cpu")
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return cls(model.state_dict(), cfg=cfg, arch=arch, **kw)

    @classmethod
    def from_flax_variables(cls, variables, cfg: Optional[I3DConfig] = None, **kw):
        """Scorer over a flax variables tree (nested mappings of arrays, e.g.
        ``stdd_tpu``'s ``ClipScorer.variables`` fetched to numpy)."""
        return cls(i3d_flax_to_torch(variables), cfg=cfg, **kw)

    @classmethod
    def from_torch_checkpoint(cls, path: str, cfg: Optional[I3DConfig] = None,
                              arch: str = "i3d_ori", **kw):
        """Serve a reference PyTorch ``.pth`` (``{"classifier": state_dict}``,
        ``{"state_dict": …}`` or a bare state dict with keys like
        ``resnet.s2.pathway0_res0.branch2.a.weight``), as
        ``stdd_tpu/runtime/classifier.py:256`` does: the reference keys go
        through :func:`~stdd_torch.utils.torch_convert.load_reference_checkpoint`
        to a flax tree, then through the weight bridge. A checkpoint that does
        not cover the model, or holds entries it lacks, raises. The file
        carries no geometry: ``cfg`` (default ``I3DConfig()``) gives it.
        FTCN-TT's ``.pth`` has no converter: ``arch="ftcn_tt"`` raises."""
        from ..utils.torch_convert import load_reference_checkpoint

        if arch != "i3d_ori":
            raise ValueError(
                f"{path}: a reference .pth is converted for arch='i3d_ori' only; FTCN-TT's "
                "conversion waits for a released checkpoint (serve a run_i3d --ftcn "
                "checkpoint with --jax_ckpt, or random weights)")
        return cls(i3d_flax_to_torch(load_reference_checkpoint(path)), cfg=cfg, **kw)

    @classmethod
    def from_jax_checkpoint(cls, path: str, cfg: Optional[I3DConfig] = None,
                            arch: str = "i3d_ori", **kw):
        """Serve weights the JAX trainer wrote (``{name}_{epoch}.msgpack``
        from ``save_checkpoint``, of either package): ``params`` and
        ``batch_stats`` go through the tolerant merge, so a trailing
        ``opt_state`` or any leaf the model lacks is ignored, and a
        checkpoint that does not cover the model (missing leaves or other
        shapes) raises. Without ``cfg`` the geometry comes from the
        trainer's ``{path}.json`` sidecar (:func:`sidecar_config`).
        ``arch="ftcn_tt"`` reads the FTCN tree ``run_i3d --ftcn`` writes."""
        if cfg is None:
            cfg = sidecar_config(path) or I3DConfig()
        cfg = arch_config(arch, cfg)
        with torch.device("meta"):
            model = build_model(arch, cfg)          # refuses what the port lacks
        to_flax, from_flax = _bridges(arch)
        # the merge reads the target's shapes only: zero-stride views, no data
        target = to_flax({k: torch.zeros(()).expand(v.shape)
                          for k, v in model.state_dict().items()})
        raw = load_checkpoint(path)
        src = {k: raw[k] for k in ("params", "batch_stats") if k in raw}
        merged, report = tolerant_merge(target, src)
        if report["missing"] or report["shape_mismatch"]:
            raise ValueError(
                f"{path} does not cover the model (cfg={cfg}): "
                f"missing={report['missing'][:5]} shape_mismatch={report['shape_mismatch'][:5]}")
        return cls(from_flax(merged), cfg=cfg, arch=arch, **kw)

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

    def _score_impl(self, crops, boxes, lm5, valid, scale=None, warp=warp_affine,
                    bottleneck=fused_bottleneck, with_features: bool = False):
        """Device tensors in, device probs out; with ``with_features`` also
        the float32 logits [B, C] and the features the head's last linear
        layer reads (not masked): the pooled [B, 2048] of ``i3d_ori``, the
        normed cls token [B, 1024] of ``ftcn_tt``. ``warp`` and
        ``bottleneck`` swap K1 and K2 for their plain versions when checking
        the kernels on the card."""
        with torch.inference_mode():
            # loud format check: a facade that forgot to forward
            # upload_format (packing.upload_format_of) must fail here
            if self.upload_format == "yuv420":
                if crops.dim() != 4:
                    raise ValueError(
                        f"upload_format='yuv420' expects planar I420 crops "
                        f"[B,T,S*3//2,S]; got shape {tuple(crops.shape)} (pack with yuv420=True)")
                with span("stdd.scorer.decode"):
                    crops = yuv420_to_rgb(crops)
            elif crops.dim() != 5:
                raise ValueError(
                    f"upload_format='rgb' expects crops [B,T,H,W,3]; got shape {tuple(crops.shape)}")
            with span("stdd.scorer.align"):
                aligned = self._align_batch(crops, boxes.float(), lm5.float(), scale, warp)
                if self.round_aligned_u8:
                    aligned = torch.round(torch.clamp(aligned, 0, 255))
            with span("stdd.scorer.trunk"):
                x = (aligned - self._mean) / self._std
                logits, feats = self.model(x, return_features=True, bottleneck=bottleneck)
                probs = torch.where(valid, torch.sigmoid(logits[:, self.score_index].float()),
                                    0.0)
            if with_features:
                return probs, logits.float(), feats
            return probs

    # -- public entry points --------------------------------------------------

    def score_device(self, crops, boxes, lm5, valid) -> torch.Tensor:
        """Upload and score without waiting: probs [B] float32 on the
        scorer's device."""
        return self._score_impl(
            self._to_device(crops), self._to_device(boxes, torch.float32),
            self._to_device(lm5, torch.float32), self._to_device(valid, torch.bool))

    def score_async(self, crops, boxes, lm5, valid, path: str = "auto") -> ProbsHandle:
        """Dispatch without blocking; returns a :class:`ProbsHandle`
        (poll ``is_ready()``, materialize with ``np.asarray``). ``path`` is
        accepted for the JAX scorer's signature and ignored: K1 serves
        every clip."""
        return ProbsHandle(self.score_device(crops, boxes, lm5, valid))

    def score(self, crops, boxes, lm5, valid) -> np.ndarray:
        return np.asarray(self.score_async(crops, boxes, lm5, valid))

    def score_with_features(self, crops, boxes, lm5, valid):
        """(probs [B], logits [B, C], penultimate features [B, 2048], or
        FTCN-TT's normed cls token [B, 1024]), float32 numpy — the
        reference's forward hook for its RGB-fusion branch
        (altfreezing/feature.py:92 AFModel)."""
        out = self._score_impl(
            self._to_device(crops), self._to_device(boxes, torch.float32),
            self._to_device(lm5, torch.float32), self._to_device(valid, torch.bool),
            with_features=True)
        return tuple(t.cpu().numpy() for t in out)

    def score_dense(self, frames, boxes, lm5, starts, batch: int = 8,
                    clip_size: Optional[int] = None) -> np.ndarray:
        """Score sliding windows of one track. ``frames`` [N, S, S, 3] uint8
        (one uniform pre-scale for the track, ``packing.pack_track``) or
        planar I420 [N, S*3//2, S], ``boxes`` [N, 4], ``lm5`` [N, 5, 2],
        ``starts`` the window starts (each ``start + clip_size <= N``) →
        probs [len(starts)] float32.

        The track goes to the device once; each batch of ``batch`` windows is
        gathered on the device with an index tensor (nothing is uploaded
        again) and aligned clip-stably from its own sliced boxes and
        landmarks; a short last batch is padded with window 0 and masked.
        The JAX scorer pads N to a multiple of 64 to bound XLA recompiles;
        eager PyTorch compiles nothing, so N is taken as it is."""
        T = clip_size or self.cfg.num_frames
        starts = np.asarray(starts, np.int64).reshape(-1)
        n = frames.shape[0]
        hi = n - T
        if starts.size and (starts.min() < 0 or starts.max() > hi):
            raise ValueError(
                f"window starts must be in [0, {hi}] for a {n}-frame track with "
                f"clip_size={T}; got [{starts.min()}, {starts.max()}]")
        out = np.zeros((starts.size,), np.float32)
        if not starts.size:
            return out
        n_pad = -(-starts.size // batch) * batch
        padded = np.zeros((n_pad,), np.int64)
        padded[:starts.size] = starts
        valid = np.arange(n_pad) < starts.size
        with torch.inference_mode():
            with span("stdd.scorer.upload"):
                frames_d = self._to_device(frames)
                boxes_d = self._to_device(boxes, torch.float32)
                lm5_d = self._to_device(lm5, torch.float32)
                idx = self._to_device(padded)[:, None] + torch.arange(T, device=self.device)
                valid_d = self._to_device(valid)
            probs = [self._score_impl(frames_d[idx[i:i + batch]], boxes_d[idx[i:i + batch]],
                                      lm5_d[idx[i:i + batch]], valid_d[i:i + batch])
                     for i in range(0, n_pad, batch)]
            with span("stdd.scorer.fetch"):
                out[:] = torch.cat(probs)[:starts.size].cpu().numpy()
        return out

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
