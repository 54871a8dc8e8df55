"""The port's split functions (``stdd_torch/data/splits.py``:
``combine_splits``, ``flatten_split``, ``save_split``, ``check_no_leakage``)
against the JAX package's on the same clip lists: equal results, and
``save_split`` writes the same bytes."""

import os

import pytest

from stdd_tpu.data import splits as jax_splits
from stdd_torch.data import splits


def tree(root, layout):
    dirs = []
    for tech, vids in layout:
        for v in vids:
            for c in range(2):
                d = os.path.join(root, tech, v, "track_0", f"clip_{c:05d}")
                os.makedirs(d, exist_ok=True)
                dirs.append(d)
    return dirs


FFPP = [("original", [f"{i:03d}" for i in range(8)]),
        ("deepfakes", ["000_003", "001_002", "004_005", "006_007"]),
        ("face2face", ["003_000", "002_001"])]


@pytest.fixture
def dirs(tmp_path):
    return tree(str(tmp_path), FFPP)


def test_combine_and_flatten_match_jax(dirs):
    a = splits.make_split(dirs, ratios=(0.5, 0.25, 0.25), seed=1)
    b = splits.make_split(dirs, ratios=(0.6, 0.2, 0.2), seed=2)
    c = {"train": dirs[:3] + dirs[:2], "test": dirs[-2:]}      # duplicates, no val
    got = splits.combine_splits([a, b, c])
    assert got == jax_splits.combine_splits([a, b, c])
    assert all(got[p] == sorted(set(got[p])) for p in splits.PHASES)
    assert splits.combine_splits([]) == jax_splits.combine_splits([])
    for s in (a, c, got):
        assert splits.flatten_split(s) == jax_splits.flatten_split(s)


def test_save_split_writes_jax_bytes(tmp_path, dirs):
    split = splits.make_split(dirs, seed=3)
    split["extra"] = ["x"]                                     # any keys, in order
    splits.save_split(split, str(tmp_path / "port.json"))
    jax_splits.save_split(split, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert splits.load_split(str(tmp_path / "port.json")) == split


@pytest.mark.parametrize("identities", [True, False])
def test_check_no_leakage_matches_jax(dirs, identities):
    cases = [splits.make_split(dirs, ratios=(0.5, 0.25, 0.25), seed=s) for s in range(4)]
    by_dir = {"train": [d for d in dirs if "/original/" in d],
              "test": [d for d in dirs if "/original/" not in d]}
    # a linked identity across phases, and one video split across phases
    cases += [by_dir, {"train": dirs[:1], "val": dirs[1:2]}, {}]
    got = [splits.check_no_leakage(s, identities) for s in cases]
    assert got == [jax_splits.check_no_leakage(s, identities) for s in cases]
    assert got[:4] == [True] * 4 and got[5] is False
    assert got[4] is (not identities)
