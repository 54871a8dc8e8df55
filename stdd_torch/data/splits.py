"""Video-grouped, identity-linked, seeded train/val/test splits.

Own copy of ``group_by_video`` (:25), ``link_identity_groups`` (:46) and
``make_split`` (:78) of ``stdd_tpu/data/splits.py`` (reference
``dualrun/data/makeFF_splits.py:64``, ``makeSplit.py:123``): no video, and
no manipulated identity, spans two phases, and one seed gives the same
lists in both packages.
"""

from __future__ import annotations

import random
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .dataset import ids_from_dir, infer_tech_from_path, label_from_dir

PHASES = ("train", "val", "test")


def group_by_video(clip_dirs: Sequence[str]) -> Dict[str, List[str]]:
    groups: Dict[str, List[str]] = defaultdict(list)
    for d in clip_dirs:
        vk, _ = ids_from_dir(d)
        groups[vk].append(d)
    return dict(groups)


def _identity_tokens(vid: str, all_vids) -> List[str]:
    """Underscore parts of a video name that name another video of the tree
    (FF++ fakes are ``<source>_<target>``) or are CelebDF ``id<k>`` actor
    ids; a name with none links only itself."""
    toks = vid.split("_")
    out = [t for t in toks if t in all_vids or re.match(r"^id\d+$", t)]
    return out or [vid]


def link_identity_groups(groups: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Merge per-video groups that share a manipulated identity, so a fake
    and the original it was made from never land in two phases."""
    all_vids = {vk.split("/", 1)[-1] for vk in groups}
    parent: Dict[str, str] = {}

    def find(a: str) -> str:
        while parent.setdefault(a, a) != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: str, b: str) -> None:
        parent[find(a)] = find(b)

    tok_owner: Dict[str, str] = {}
    for vk in sorted(groups):
        vid = vk.split("/", 1)[-1]
        for tok in _identity_tokens(vid, all_vids):
            if tok in tok_owner:
                union(vk, tok_owner[tok])
            else:
                tok_owner[tok] = vk
    merged: Dict[str, List[str]] = defaultdict(list)
    for vk in sorted(groups):
        merged[find(vk)].extend(groups[vk])
    return dict(merged)


def make_split(
    clip_dirs: Sequence[str],
    ratios: Tuple[float, float, float] = (0.7, 0.15, 0.15),
    seed: int = 42,
    per_tech_cap: Optional[int] = None,
    link_identities: bool = True,
) -> Dict[str, List[str]]:
    """Video-grouped 3-way split, stratified by (technique, label)."""
    if abs(sum(ratios) - 1.0) >= 1e-6:
        raise ValueError(f"split ratios {ratios} must sum to 1")
    groups = group_by_video(clip_dirs)
    if link_identities:
        groups = link_identity_groups(groups)
    buckets: Dict[Tuple[str, int], List[str]] = defaultdict(list)
    for vk, dirs in groups.items():
        buckets[(infer_tech_from_path(dirs[0]), label_from_dir(dirs[0]))].append(vk)

    rng = random.Random(seed)
    out: Dict[str, List[str]] = {p: [] for p in PHASES}
    for key in sorted(buckets):
        vids = sorted(buckets[key])
        rng.shuffle(vids)
        if per_tech_cap:
            vids = vids[:per_tech_cap]
        n = len(vids)
        n_train = int(round(n * ratios[0]))
        n_val = int(round(n * ratios[1]))
        phases = (
            [("train", v) for v in vids[:n_train]]
            + [("val", v) for v in vids[n_train: n_train + n_val]]
            + [("test", v) for v in vids[n_train + n_val:]]
        )
        for phase, vk in phases:
            out[phase].extend(groups[vk])
    for p in PHASES:
        out[p].sort()
    return out
