"""Clip paths of the preprocessing tree, and the dual encoder's feature
dataset over them.

Own copy of ``stdd_tpu/data/dataset.py`` (reference
``dualrun/data/dataset_dual.py``): the path helpers (``REAL_TOKENS`` :24,
``infer_tech_from_path`` :40, ``label_from_dir`` :64, ``ids_from_dir``
:69) and ``DualFeaturesClipDataset`` (:81) in numpy: mmap loading, per-clip
or global z-scoring, ``stitch_k`` windows over consecutive clips of a
track, the feature-space augmentations (noise, temporal dropout, landmark
affine jitter, dropouts, EMA smoothing) drawn from one
``np.random.RandomState`` in the JAX version's order, technique / domain /
track / video ids from the paths, and ``load_all`` into the array dict
``train/engine_dual.train_dual`` takes.
"""

from __future__ import annotations

import glob
import math
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

REAL_TOKENS = {"original", "origina", "pristine", "authentic", "real",
               "youtube-real", "celeb-real"}

_ALIASES = {
    "deepfakedetection": "dfdc", "dfdc": "dfdc",
    "deepfakes": "deepfakes", "face2face": "face2face",
    "faceswap": "faceswap", "neuraltextures": "neuraltextures",
    "faceshifter": "faceshifter", "stylegan": "stylegan",
    "styleswap": "styleswap",
    "celebdf": "celebdf", "celebsynthesis": "celebdf",
    "celebd": "celebd", "uadfv": "uadfv",
    "ffpp": "ffpp", "ff++": "ffpp",
}


def infer_tech_from_path(path: str) -> str:
    """Manipulation technique from a clip path (dataset_dual.py:10)."""
    p = path.lower().replace("\\", "/")
    parts = [s for s in p.split("/") if s]
    if any(s in REAL_TOKENS for s in parts):
        return "real"

    def norm(s):
        return s.replace("-", "").replace("_", "")

    for seg in parts:
        if norm(seg) in _ALIASES:
            return _ALIASES[norm(seg)]
    for k in _ALIASES:
        if f"/{k}/" in p:
            return _ALIASES[k]
    skip = ("track_", "fold_", "split_", "part_", "seg_")
    parts2 = [s for s in parts if not any(s.startswith(pr) for pr in skip)]
    for i, seg in enumerate(parts2):
        if seg.startswith("clip_") and i > 0:
            return _ALIASES.get(norm(parts2[i - 1]), parts2[i - 1])
    return "unknown"


def label_from_dir(d: str) -> int:
    """0 for a real clip (any path segment in ``REAL_TOKENS``), else 1."""
    tokens = [s for s in d.lower().replace("\\", "/").split("/") if s]
    return 0 if any(t in REAL_TOKENS for t in tokens) else 1


def ids_from_dir(d: str) -> Tuple[str, str]:
    """(video_key, track_key) from a clip dir (dataset_dual.py:294)."""
    p = d.replace("\\", "/").split("/")
    track = next((s for s in p if re.match(r"track_\d+$", s)), None)
    if not track:
        return "unknown/unknown", "unknown/unknown/track_0"
    i = p.index(track)
    tech = p[i - 2] if i >= 2 else "unknown"
    vid = p[i - 1] if i >= 1 else "unknown"
    return f"{tech}/{vid}", f"{tech}/{vid}/{track}"


class DualFeaturesClipDataset:
    def __init__(
        self,
        root_dir: Optional[str] = None,
        clip_dirs: Optional[Iterable[str]] = None,
        T: int = 8,
        stitch_k: int = 1,
        is_train: bool = False,
        random_crop: bool = True,
        zscore: str = "clip",            # clip | global | none
        norm_stats_path: Optional[str] = None,
        mmap: bool = True,
        allow_missing_au: bool = False,
        eject_broken: bool = True,
        au_dim: Optional[int] = None,
        lmk_dim: Optional[int] = None,
        # feature-space augmentations (train only; dataset_dual.py:399-455)
        aug_noise_au: float = 0.0,
        aug_noise_lmk: float = 0.0,
        aug_tdrop: float = 0.0,
        lmk_affine_deg: float = 0.0,
        lmk_dropout_p: float = 0.0,
        au_dropout_p: float = 0.0,
        lmk_temporal_alpha: float = 0.0,
        au_temporal_alpha: float = 0.0,
        seed: int = 0,
        eps: float = 1e-6,
    ):
        if clip_dirs is None:
            assert root_dir, "need root_dir or clip_dirs"
            clip_dirs = sorted(
                glob.glob(os.path.join(root_dir, "**", "track_*", "clip_*"), recursive=True)
            )
        self.T = T
        self.stitch_k = int(stitch_k)
        self.is_train = is_train
        self.random_crop = random_crop
        self.zscore = zscore
        self.mmap = mmap
        self.allow_missing_au = allow_missing_au
        self.eps = eps
        self.aug = dict(
            noise_au=aug_noise_au, noise_lmk=aug_noise_lmk, tdrop=aug_tdrop,
            lmk_affine_deg=lmk_affine_deg, lmk_dropout_p=lmk_dropout_p,
            au_dropout_p=au_dropout_p, lmk_alpha=lmk_temporal_alpha,
            au_alpha=au_temporal_alpha,
        )
        self.rng = np.random.RandomState(seed)

        samples = []
        for d in clip_dirs:
            lm_p = os.path.join(d, "lmk_features.npy")
            au_p = os.path.join(d, "au_features.npy")
            if not os.path.isfile(lm_p):
                continue
            if not self.allow_missing_au and not os.path.isfile(au_p):
                continue
            samples.append((au_p, lm_p, label_from_dir(d), d))
        if eject_broken:
            ok = []
            for au_p, lm_p, lab, d in samples:
                if self._safe_load(lm_p) is None:
                    continue
                if os.path.isfile(au_p) and self._safe_load(au_p) is None:
                    continue
                ok.append((au_p, lm_p, lab, d))
            samples = ok
        if not samples:
            raise RuntimeError("no usable clips found")

        # feature dims
        if au_dim and lmk_dim:
            self.au_dim, self.lmk_dim = au_dim, lmk_dim
        else:
            self.au_dim, self.lmk_dim = 36, 132
            for au_p, lm_p, _, _ in samples[:1024]:
                try:
                    L = np.load(lm_p, mmap_mode="r")
                    A = np.load(au_p, mmap_mode="r") if os.path.isfile(au_p) else None
                    if L.ndim == 2:
                        self.lmk_dim = int(L.shape[1])
                        if A is not None and A.ndim == 2:
                            self.au_dim = int(A.shape[1])
                        break
                except Exception:
                    continue

        self.norm_stats = None
        if zscore == "global" and norm_stats_path:
            S = np.load(norm_stats_path)
            self.norm_stats = {
                "au_mean": S["au_mean"], "au_std": np.maximum(S["au_std"], eps),
                "lmk_mean": S["lmk_mean"], "lmk_std": np.maximum(S["lmk_std"], eps),
            }

        # stitching (dataset_dual.py:246-274)
        self.items: List[Tuple[str, Union[tuple, List[tuple]]]] = []
        if self.stitch_k <= 1:
            self.items = [("single", s) for s in samples]
        else:
            buckets: Dict[str, List] = {}
            for au, lm, lab, d in samples:
                segs = d.replace("\\", "/").split("/")
                track = next((s for s in segs if s.startswith("track_")), None)
                clip_s = next((s for s in segs if s.startswith("clip_")), None)
                if not track or not clip_s:
                    continue
                try:
                    ci = int(clip_s.split("_")[-1])
                except Exception:
                    ci = -1
                key = "/".join(segs[: segs.index(track) + 1])
                buckets.setdefault(key, []).append((au, lm, lab, d, ci))
            for key in buckets:
                buckets[key].sort(key=lambda r: r[-1])
            for lst in buckets.values():
                if len(lst) < self.stitch_k:
                    continue
                for i in range(len(lst) - self.stitch_k + 1):
                    self.items.append(
                        ("window", [(a, l, y, d) for a, l, y, d, _ in lst[i : i + self.stitch_k]])
                    )
        if not self.items:
            raise RuntimeError("no samples after stitching")

        self.labels, self.tech_names = [], []
        self.vid_keys, self.track_keys = [], []
        for kind, payload in self.items:
            d = payload[3] if kind == "single" else payload[0][3]
            lab = payload[2] if kind == "single" else payload[0][2]
            self.labels.append(int(lab))
            self.tech_names.append(infer_tech_from_path(d))
            vk, tk = ids_from_dir(d)
            self.vid_keys.append(vk)
            self.track_keys.append(tk)

        fake_techs = sorted(
            {t for t, y in zip(self.tech_names, self.labels) if y == 1 and t != "unknown"}
        )
        self.domain_map = {t: i + 1 for i, t in enumerate(fake_techs)}  # real=0
        self.n_domains = 1 + len(fake_techs)
        uniq_vid = {k: i for i, k in enumerate(sorted(set(self.vid_keys)))}
        uniq_trk = {k: i for i, k in enumerate(sorted(set(self.track_keys)))}
        self.vid_ids = np.array([uniq_vid[k] for k in self.vid_keys], np.int64)
        self.trk_ids = np.array([uniq_trk[k] for k in self.track_keys], np.int64)

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.items)

    def _safe_load(self, path: str) -> Optional[np.ndarray]:
        try:
            return np.load(path, mmap_mode="r" if self.mmap else None)
        except Exception:
            try:
                return np.load(path)
            except Exception:
                return None

    def _load_clip(self, au_p, lm_p):
        L = self._safe_load(lm_p)
        if L is None:
            return (np.zeros((0, self.au_dim), np.float32),
                    np.zeros((0, self.lmk_dim), np.float32))
        L = np.asarray(L, np.float32)
        A = self._safe_load(au_p) if os.path.isfile(au_p) else None
        if A is None:
            A = np.zeros((L.shape[0], self.au_dim), np.float32)
        else:
            A = np.asarray(A, np.float32)
        n = min(len(A), len(L))
        return self._fix_dim(A[:n], self.au_dim), self._fix_dim(L[:n], self.lmk_dim)

    @staticmethod
    def _fix_dim(X, want):
        if X.ndim != 2:
            return np.zeros((0, want), np.float32)
        if X.shape[1] == want:
            return X
        if X.shape[1] > want:
            return X[:, :want]
        return np.concatenate(
            [X, np.zeros((X.shape[0], want - X.shape[1]), np.float32)], axis=1
        )

    def _pad(self, X: np.ndarray) -> Tuple[np.ndarray, int]:
        t = X.shape[0]
        if t >= self.T:
            return X[: self.T], self.T
        out = np.zeros((self.T, X.shape[1]), np.float32)
        out[:t] = X
        return out, t

    def _z(self, X: np.ndarray, kind: str) -> np.ndarray:
        if X.size == 0:
            return X
        if self.zscore == "clip":
            mu = X.mean(0, keepdims=True)
            sd = np.maximum(X.std(0, keepdims=True), self.eps)
            return (X - mu) / sd
        if self.zscore == "global" and self.norm_stats is not None:
            return (X - self.norm_stats[f"{kind}_mean"]) / self.norm_stats[f"{kind}_std"]
        return X

    @staticmethod
    def _ema(X, alpha):
        # single source of truth with eval-time smoothing
        # (collect_logits(smooth_alpha=...)): the two conventions MUST stay
        # identical, so delegate to the [B,T,D] implementation
        from ..train.metrics import ema_1d

        if X.shape[0] <= 1:
            return X
        return ema_1d(X[None], alpha)[0]

    def _augment(self, A: np.ndarray, L: np.ndarray):
        a = self.aug
        rng = self.rng
        if L.size and L.shape[1] % 2 == 0:
            T_, Fl = L.shape
            P = Fl // 2
            X = L.reshape(T_, P, 2).copy()
            if a["lmk_affine_deg"] > 0:
                th = math.radians(rng.uniform(-a["lmk_affine_deg"], a["lmk_affine_deg"]))
                c, s = math.cos(th), math.sin(th)
                R = np.array([[c, -s], [s, c]], np.float32)
                scale = 1.0 + rng.uniform(-0.02, 0.02)
                t = rng.uniform(-0.01, 0.01, 2).astype(np.float32)
                X = X @ (R * scale) + t
            if a["noise_lmk"] > 0:
                X = X + rng.randn(*X.shape).astype(np.float32) * a["noise_lmk"]
            if a["lmk_dropout_p"] > 0:
                mask = (rng.rand(P) > a["lmk_dropout_p"]).astype(np.float32)
                X = X * mask[None, :, None]
            L = X.reshape(T_, Fl)
        if a["lmk_alpha"] > 0:
            L = self._ema(L, a["lmk_alpha"])
        if a["noise_au"] > 0:
            A = A + self.rng.randn(*A.shape).astype(np.float32) * a["noise_au"]
        if a["au_dropout_p"] > 0:
            A = A * (rng.rand(*A.shape) > a["au_dropout_p"]).astype(np.float32)
        if a["au_alpha"] > 0:
            A = self._ema(A, a["au_alpha"])
        if a["tdrop"] > 0 and A.shape[0] > 2:
            keep = rng.rand(A.shape[0]) > a["tdrop"]
            keep[0] = True
            A, L = A[keep], L[keep]
        return A.astype(np.float32), L.astype(np.float32)

    def __getitem__(self, i: int):
        kind, payload = self.items[i]
        if kind == "single":
            au_p, lm_p, lab, d = payload
            A, L = self._load_clip(au_p, lm_p)
        else:
            As, Ls = [], []
            lab = payload[0][2]
            for au_p, lm_p, _, _ in payload:
                a_, l_ = self._load_clip(au_p, lm_p)
                As.append(a_)
                Ls.append(l_)
            A = np.concatenate(As) if As else np.zeros((0, self.au_dim), np.float32)
            L = np.concatenate(Ls) if Ls else np.zeros((0, self.lmk_dim), np.float32)

        # ONE shared crop offset keeps AU and landmark streams frame-aligned
        n = min(A.shape[0], L.shape[0])
        A, L = A[:n], L[:n]
        if n > self.T:
            if self.is_train and self.random_crop:
                s0 = self.rng.randint(0, n - self.T + 1)
            else:
                s0 = 0
            A, L = A[s0 : s0 + self.T].copy(), L[s0 : s0 + self.T].copy()
        else:
            A, L = A.copy(), L.copy()
        if self.is_train:
            A, L = self._augment(A, L)
        A = self._z(A, "au")
        L = self._z(L, "lmk")
        A, t_valid = self._pad(A)
        L, _ = self._pad(L)
        return {
            "A": A, "L": L, "y": float(self.labels[i]), "lengths": t_valid,
            "dom_id": self.domain_map.get(self.tech_names[i], 0),
            "trk": int(self.trk_ids[i]), "vid": int(self.vid_ids[i]),
        }

    def load_all(self, indices: Optional[Iterable[int]] = None) -> Dict[str, np.ndarray]:
        """Materialize into the array dict consumed by train_dual."""
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
