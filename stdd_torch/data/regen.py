"""On-the-fly robustness dataset: raw videos → degraded clips → features.

Port of ``stdd_tpu/data/regen.py`` (the reference's
``dualrun/data/dataset_regen.py:125`` DualVideoRegenDataset): decode frames
at a stride, apply the label-agnostic degradation chain
(:mod:`stdd_torch.data.degrade`), extract landmark features on the fly with
a pluggable landmarker, and emit the trainer's array format. Videos are
``.y4m`` (:func:`stdd_torch.utils.video_io.read_y4m`), the port's video
container. The landmarker and the AU extractor are callables, as in JAX; on
the card the port's ``DenseLandmarker`` and ``AUExtractor`` serve as them.
The reference emits ZERO AUs (:239), and so does this dataset unless an AU
extractor is supplied.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..ops.align import resize_u8
from ..utils.video_io import i420_to_bgr, iter_y4m_planes
from .dataset import infer_tech_from_path, label_from_dir
from .degrade import ClipDegrader
from .features import LMK_FEATURE_DIM, au_seq_to_features, lmk_seq_to_features


def read_frames_strided(path: str, T: int, stride: int = 2,
                        start: int = 0) -> List[np.ndarray]:
    """Decode T frames at a fixed stride (dataset_regen.py:109
    _read_frames_at); the frames between are skipped undecoded."""
    frames: List[np.ndarray] = []
    if T <= 0:
        return frames
    for idx, (buf, h, w) in enumerate(iter_y4m_planes(path)):
        if idx >= start and (idx - start) % stride == 0:
            frames.append(i420_to_bgr(np.frombuffer(buf, np.uint8), h, w))
            if len(frames) == T:
                break
    return frames


def _face_crop(frame_bgr: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Square crop of the landmark bbox with 25% margin, clamped in-frame."""
    H, W = frame_bgr.shape[:2]
    (x1, y1), (x2, y2) = pts.min(axis=0), pts.max(axis=0)
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    half = max(x2 - x1, y2 - y1) * 0.625
    xa, xb = int(max(0, cx - half)), int(min(W, cx + half))
    ya, yb = int(max(0, cy - half)), int(min(H, cy + half))
    if xb <= xa + 1 or yb <= ya + 1:
        return frame_bgr
    return frame_bgr[ya:yb, xa:xb]


def _resize256(img: np.ndarray) -> np.ndarray:
    # one resample to the LibreFace transform's input scale (256-resize /
    # 224-center-crop happens inside the extractor); cv2.resize's default
    # INTER_LINEAR, bit for bit
    return resize_u8(img, (256, 256))


class DualVideoRegenDataset:
    """Videos in, degraded (A, L, y) clips out."""

    def __init__(
        self,
        video_paths: Sequence[str],
        landmarker: Callable[[np.ndarray], Optional[np.ndarray]],
        T: int = 8,
        frame_stride: int = 2,
        is_train: bool = True,
        au_dim: int = 36,
        au_extractor=None,
        degrader: Optional[ClipDegrader] = None,
        seed: int = 0,
    ):
        self.video_paths = list(video_paths)
        self.landmarker = landmarker
        self.T = T
        self.frame_stride = frame_stride
        self.is_train = is_train
        self.au_dim = au_dim
        self.au_extractor = au_extractor
        self.degrader = degrader or ClipDegrader(seed=seed)
        self.labels = [label_from_dir(p) for p in self.video_paths]
        self.tech_names = [infer_tech_from_path(p) for p in self.video_paths]
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.video_paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        path = self.video_paths[i]
        start = self.rng.randint(0, 8) if self.is_train else 0
        frames = read_frames_strided(path, self.T, self.frame_stride, start)
        if self.is_train and frames:
            frames = self.degrader(frames)
        lmk_rows: List[np.ndarray] = []
        faces: List[np.ndarray] = []
        for f in frames:
            pts = self.landmarker(f[:, :, ::-1])
            if pts is None:
                continue
            feat = lmk_seq_to_features([pts])
            if len(feat):
                lmk_rows.append(feat[0])
                # the AU extractor's LibreFace transform expects a FACE
                # crop, not the whole frame: the landmark bbox with 25% margin
                faces.append(_face_crop(f, np.asarray(pts)))
        L = np.zeros((self.T, LMK_FEATURE_DIM), np.float32)
        A = np.zeros((self.T, self.au_dim), np.float32)
        n = min(self.T, len(lmk_rows))
        if n:
            L[:n] = np.stack(lmk_rows[:n])
            if self.au_extractor is not None:
                dicts = self.au_extractor(
                    np.stack([_resize256(c[:, :, ::-1]) for c in faces[:n]]))
                A[:n] = au_seq_to_features(dicts)[:, : self.au_dim]
        return {
            "A": A, "L": L, "y": float(self.labels[i]), "lengths": n,
            "dom_id": 0, "trk": i, "vid": i,
        }

    def load_all(self, indices=None) -> Dict[str, np.ndarray]:
        idx = list(indices) if indices is not None else range(len(self))
        rows = [self[i] for i in idx]
        return {
            "A": np.stack([r["A"] for r in rows]),
            "L": np.stack([r["L"] for r in rows]),
            "y": np.asarray([r["y"] for r in rows], np.float32),
            "lengths": np.asarray([r["lengths"] for r in rows], np.int32),
            "dom_id": np.asarray([r["dom_id"] for r in rows], np.int32),
            "trk": np.asarray([r["trk"] for r in rows], np.int64),
            "vid": np.asarray([r["vid"] for r in rows], np.int64),
            "tech": [self.tech_names[i] for i in idx],
        }
