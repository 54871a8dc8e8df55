"""Labels, techniques and ids from a clip path of the preprocessing tree.

Own copy of the path helpers of ``stdd_tpu/data/dataset.py`` (``REAL_TOKENS``
:24, ``infer_tech_from_path`` :40, ``label_from_dir`` :64, ``ids_from_dir``
:69; reference ``dualrun/data/dataset_dual.py``). The feature dataset of that
module waits for the dual-encoder family.
"""

from __future__ import annotations

import re
from typing import Tuple

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
