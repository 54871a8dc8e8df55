"""VoxCeleb landmark pretraining data plumbing.

Port of ``stdd_tpu/data/vox.py`` (reference ``dualrun/data/vox_index.py:14``
build_index, ``vox_ds.py:5`` VoxLmkDataset, ``:19`` collate_pad):
speaker-disjoint train/val split over a tree of landmark-feature files,
per-clip loading with optional time-warp augmentation, and zero-padded
batch collation with length masks. Host numpy with JAX's generators
(``random.Random``, ``np.random.RandomState``) drawn in JAX's order, so
the index, the draws and the batches are JAX's."""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def build_index(
    root: str, val_ratio: float = 0.05, tmin: int = 8, seed: int = 0,
    pattern: str = "**/lmk_features.npy",
) -> Dict[str, List[str]]:
    """Speaker-split index: first path segment under root = speaker id; no
    speaker spans both phases (vox_index.py:14)."""
    files = sorted(glob.glob(os.path.join(root, pattern), recursive=True))
    by_speaker: Dict[str, List[str]] = {}
    for f in files:
        rel = os.path.relpath(f, root)
        speaker = rel.split(os.sep)[0]
        try:
            arr = np.load(f, mmap_mode="r")
            if arr.ndim != 2 or arr.shape[0] < tmin:
                continue
        except Exception:
            continue
        by_speaker.setdefault(speaker, []).append(f)
    speakers = sorted(by_speaker)
    rng = random.Random(seed)
    rng.shuffle(speakers)
    n_val = max(1, int(len(speakers) * val_ratio)) if speakers else 0
    # the seed-shuffled LIST, not a set: a set's order of strings depends on
    # PYTHONHASHSEED and would make the val file order irreproducible
    return {
        "train": [f for s in speakers[n_val:] for f in by_speaker[s]],
        "val": [f for s in speakers[:n_val] for f in by_speaker[s]],
    }


def time_warp(X: np.ndarray, rng: np.random.RandomState, max_stretch: float = 0.2) -> np.ndarray:
    """Random temporal stretch via linear resampling (vox_ds.py time-warp)."""
    T = X.shape[0]
    if T < 4:
        return X
    factor = 1.0 + rng.uniform(-max_stretch, max_stretch)
    T2 = max(4, int(round(T * factor)))
    src = np.linspace(0, T - 1, T2)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, T - 1)
    w = (src - lo)[:, None]
    return (1 - w) * X[lo] + w * X[hi]


class VoxLmkDataset:
    def __init__(self, files: Sequence[str], T: int = 32, is_train: bool = False,
                 seed: int = 0):
        self.files = list(files)
        self.T = T
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        X = np.asarray(np.load(self.files[i]), np.float32)
        if self.is_train:
            X = time_warp(X, self.rng).astype(np.float32)
            if X.shape[0] > self.T:
                s = self.rng.randint(0, X.shape[0] - self.T + 1)
                X = X[s : s + self.T]
        return X[: self.T]

    def batches(self, batch_size: int, shuffle: Optional[bool] = None):
        order = np.arange(len(self))
        if shuffle if shuffle is not None else self.is_train:
            self.rng.shuffle(order)
        if 0 < len(order) < batch_size:
            # smaller than one batch: emit it whole rather than yield
            # nothing (tails of larger datasets still drop,
            # DistributedSampler-style)
            yield collate_pad([self[int(i)] for i in order], self.T)
            return
        for s in range(0, len(order) - batch_size + 1, batch_size):
            seqs = [self[int(i)] for i in order[s : s + batch_size]]
            yield collate_pad(seqs, self.T)


def collate_pad(seqs: Sequence[np.ndarray], T: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad to [B, T, D] + integer lengths (vox_ds.py:19 collate_pad)."""
    D = seqs[0].shape[1]
    B = len(seqs)
    out = np.zeros((B, T, D), np.float32)
    lengths = np.zeros(B, np.int32)
    for i, x in enumerate(seqs):
        n = min(T, x.shape[0])
        out[i, :n] = x[:n]
        lengths[i] = n
    return out, lengths
