"""The port's VoxCeleb landmark pretraining data against the JAX package's
(``stdd_torch/data/vox.py`` vs ``stdd_tpu/data/vox.py``) on the same tree
of ``lmk_features.npy`` files: speakers of several clips, files shorter
than ``tmin``, a 1-D array and a file that is not ``.npy``.

Tolerance: none. Both draw from ``random.Random`` and
``np.random.RandomState`` of the same seed in the same order, so the index
lists, every item, every batch and its lengths are equal, and the
generators end in the same state.
"""

import os

import numpy as np
import pytest

import stdd_tpu.data.vox as J
import stdd_torch.data.vox as P


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("vox")
    rng = np.random.RandomState(0)
    for s in range(9):
        for c in range(1 + s % 3):
            d = root / f"id{s:03d}" / f"clip{c}"
            d.mkdir(parents=True)
            n = int(rng.randint(4, 60))
            np.save(d / "lmk_features.npy", rng.randn(n, 132).astype(np.float32))
    np.save(root / "id000" / "clip0" / "extra.npy", np.zeros((3, 132), np.float32))
    (root / "id100" / "a").mkdir(parents=True)
    np.save(root / "id100" / "a" / "lmk_features.npy", np.zeros(40, np.float32))
    (root / "id101" / "a").mkdir(parents=True)
    (root / "id101" / "a" / "lmk_features.npy").write_bytes(b"not an array")
    return str(root)


@pytest.mark.parametrize("val_ratio,tmin,seed", [(0.05, 8, 0), (0.3, 8, 3), (0.5, 20, 1),
                                                 (0.2, 1000, 0)])
def test_build_index_matches_jax(tree, val_ratio, tmin, seed):
    got = P.build_index(tree, val_ratio, tmin, seed)
    want = J.build_index(tree, val_ratio, tmin, seed)
    assert got == want
    speakers = {k: {os.path.relpath(f, tree).split(os.sep)[0] for f in v} for k, v in got.items()}
    assert not speakers["train"] & speakers["val"]


@pytest.mark.parametrize("is_train,batch,T", [(True, 4, 32), (False, 4, 32), (True, 64, 16),
                                              (True, 3, 8)], ids=["train", "eval", "whole", "short"])
def test_dataset_batches_match_jax(tree, is_train, batch, T):
    files = P.build_index(tree, 0.2, 8, 0)["train"]
    ds, jds = P.VoxLmkDataset(files, T=T, is_train=is_train, seed=5), \
        J.VoxLmkDataset(files, T=T, is_train=is_train, seed=5)
    got, want = list(ds.batches(batch)), list(jds.batches(batch))
    assert len(got) == len(want) == (1 if batch > len(files) else len(files) // batch)
    for (x, n), (xw, nw) in zip(got, want):
        np.testing.assert_array_equal(x, xw)
        np.testing.assert_array_equal(n, nw)
        assert x.dtype == xw.dtype == np.float32 and n.dtype == nw.dtype == np.int32
    assert ds.rng.randint(1 << 30) == jds.rng.randint(1 << 30)


def test_time_warp_and_collate_match_jax():
    X = np.random.RandomState(2).randn(23, 6).astype(np.float32)
    for seed in range(4):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(P.time_warp(X, a), J.time_warp(X, b))
        np.testing.assert_array_equal(P.time_warp(X[:3], a), J.time_warp(X[:3], b))
    seqs = [X[:5], X, X[:1]]
    for T in (4, 23, 30):
        for got, want in zip(P.collate_pad(seqs, T), J.collate_pad(seqs, T)):
            np.testing.assert_array_equal(got, want)
