"""Image-clip dataset for I3D AltFreezing training.

Port of ``stdd_tpu/data/dataset_i3d.py`` (``I3DClipDataset`` :24): clips
come from the preprocessing tree (``**/track_*/clip_*/images.npy``),
overlapping clips of a track are stitched to the model's clip length, and
training applies the pixel augmentations of the FTCN recipe
(``setting/ftcn_tt.yaml``: color jitter, gaussian noise and blur, JPEG
recompression, erase). Every draw comes from the dataset's
``np.random.RandomState`` in the JAX package's order, so one seed gives the
same windows, crop starts, jitter, erase boxes and qualities in both
packages; blur and JPEG are :mod:`stdd_torch.data.degrade`, bit-equal to
the cv2 calls of the JAX package.

``geo_jitter > 0`` (a clip-consistent ``cv2.warpAffine``, off by default)
is not ported and is refused.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import infer_tech_from_path, label_from_dir
from .degrade import gaussian_blur, jpeg_recompress

# the preprocess writer's stride between consecutive clips of a track
# (stdd_tpu/data/preprocess.py:34; clips are 8 frames, so they overlap)
CLIP_STEP = 4


class I3DClipDataset:
    def __init__(
        self,
        root_dir: Optional[str] = None,
        clip_dirs: Optional[Sequence[str]] = None,
        T: int = 32,
        is_train: bool = False,
        color_jitter: float = 0.4,
        p_gauss_blur: float = 0.05,
        p_gauss_noise: float = 0.1,
        p_jpeg: float = 0.3,
        p_erase: float = 0.3,
        geo_jitter: float = 0.0,
        seed: int = 0,
        clip_step: Optional[int] = None,  # writer stride; None = CLIP_STEP
    ):
        if geo_jitter > 0:
            raise ValueError(
                f"geo_jitter={geo_jitter}: the clip-consistent similarity jitter needs "
                "cv2.warpAffine and is not ported yet (ROADMAP §1 item 4)")
        if clip_dirs is None:
            if not root_dir:
                raise ValueError("I3DClipDataset needs root_dir or clip_dirs")
            clip_dirs = sorted(glob.glob(os.path.join(root_dir, "**", "track_*", "clip_*"),
                                         recursive=True))
        # group consecutive clips per track to stitch up to T frames
        buckets: Dict[str, List[Tuple[int, str]]] = {}
        for d in clip_dirs:
            if not os.path.isfile(os.path.join(d, "images.npy")):
                continue
            segs = d.replace("\\", "/").split("/")
            track = next((s for s in segs if s.startswith("track_")), None)
            clip_s = next((s for s in segs if s.startswith("clip_")), None)
            if not track or not clip_s:
                continue
            try:
                ci = int(clip_s.split("_")[-1])
            except ValueError:
                ci = -1
            key = "/".join(segs[: segs.index(track) + 1])
            buckets.setdefault(key, []).append((ci, d))

        self.windows: List[List[str]] = []
        self.labels: List[int] = []
        self.tech_names: List[str] = []
        self.track_keys: List[str] = []
        for key in sorted(buckets):
            lst = [d for _, d in sorted(buckets[key])]
            try:
                t_clip = np.load(os.path.join(lst[0], "images.npy"), mmap_mode="r").shape[0]
            except (OSError, ValueError):
                continue
            # clip i+1 starts clip_step frames after clip i, so k stitched
            # clips hold t_clip + (k-1)*step unique frames
            step = min(clip_step if clip_step is not None else CLIP_STEP, t_clip)
            need = 1 if T <= t_clip else 1 + -(-(T - t_clip) // step)
            # a track shorter than one window still trains: the last frame pads it
            spans = ([lst] if len(lst) < need
                     else [lst[i: i + need] for i in range(len(lst) - need + 1)])
            for win in spans:
                self.windows.append(win)
                self.labels.append(label_from_dir(win[0]))
                self.tech_names.append(infer_tech_from_path(win[0]))
                self.track_keys.append(key)
        if not self.windows:
            raise RuntimeError("no image clips found")
        self.clip_step = clip_step if clip_step is not None else CLIP_STEP
        self.T = T
        self.is_train = is_train
        self.aug = dict(color_jitter=color_jitter, p_gauss_blur=p_gauss_blur,
                        p_gauss_noise=p_gauss_noise, p_jpeg=p_jpeg, p_erase=p_erase)
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.windows)

    def _augment(self, clip: np.ndarray) -> np.ndarray:
        """Clip-consistent pixel augmentations: one draw of each parameter
        serves every frame, as the temporal model requires."""
        rng = self.rng
        a = self.aug
        out = clip.astype(np.float32)
        if a["color_jitter"] > 0:
            b = 1.0 + rng.uniform(-a["color_jitter"], a["color_jitter"])
            c = 1.0 + rng.uniform(-a["color_jitter"], a["color_jitter"])
            mean = out.mean()
            out = np.clip((out - mean) * c + mean * b, 0, 255)
        if rng.rand() < a["p_gauss_noise"]:
            out = np.clip(out + rng.randn(*out.shape) * 5.0, 0, 255)
        out = out.astype(np.uint8)
        if rng.rand() < a["p_gauss_blur"]:
            out = gaussian_blur(out, int(rng.choice([3, 5])))
        if rng.rand() < a["p_jpeg"]:
            out = jpeg_recompress(out, rng.randint(60, 95))
        if rng.rand() < a["p_erase"]:
            h, w = out.shape[1:3]
            eh, ew = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
            y0, x0 = rng.randint(0, h - eh), rng.randint(0, w - ew)
            out[:, y0: y0 + eh, x0: x0 + ew] = 0
        return out

    def _stitch(self, dirs: List[str]) -> np.ndarray:
        """Unique, time-ordered frames of overlapping consecutive clips: by
        the writer's ``frame_ids.npy`` where every clip has one, else each
        later clip adds its last ``clip_step`` frames."""
        clips = [np.load(os.path.join(d, "images.npy")) for d in dirs]
        fid_paths = [os.path.join(d, "frame_ids.npy") for d in dirs]
        if all(os.path.isfile(p) for p in fid_paths):
            seen, keep = set(), []
            for c, f in zip(clips, (np.load(p) for p in fid_paths)):
                for frame, fid in zip(c, f):
                    if int(fid) not in seen:
                        seen.add(int(fid))
                        keep.append(frame)
            return np.stack(keep)
        step = min(self.clip_step, clips[0].shape[0])
        parts = [clips[0]] + [c[c.shape[0] - step:] for c in clips[1:]]
        return np.concatenate(parts)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        frames = self._stitch(self.windows[i])
        if frames.shape[0] >= self.T:
            if self.is_train:
                s = self.rng.randint(0, frames.shape[0] - self.T + 1)
                frames = frames[s: s + self.T]
            else:
                frames = frames[: self.T]
        else:  # pad with the last frame (TEST2.py:358)
            pad = np.repeat(frames[-1:], self.T - frames.shape[0], axis=0)
            frames = np.concatenate([frames, pad])
        if self.is_train:
            frames = self._augment(frames)
        return {"clip": frames, "y": float(self.labels[i])}

    def batches(self, batch_size: int, shuffle: Optional[bool] = None,
                seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``(clips [B, T, H, W, 3] uint8, labels [B] float32)`` in a seeded
        order (shuffled when training); the tail short of a batch is
        dropped, except that a dataset smaller than one batch comes whole."""
        order = np.arange(len(self))
        if shuffle if shuffle is not None else self.is_train:
            np.random.RandomState(seed).shuffle(order)
        if 0 < len(order) < batch_size:
            spans = [order]
        else:
            spans = [order[s: s + batch_size]
                     for s in range(0, len(order) - batch_size + 1, batch_size)]
        for idx in spans:
            rows = [self[int(i)] for i in idx]
            yield (np.stack([r["clip"] for r in rows]),
                   np.asarray([r["y"] for r in rows], np.float32))
