"""The dual encoder's data, samplers, metrics, evaluator and CLI in the port
(``stdd_torch/data/features.py``, ``data/dataset.py``,
``train/samplers.py``, ``train/metrics.py``, ``eval/best.py``,
``train/run_dual.py``) against the JAX package's.

The feature builders, the dataset (every augmentation on, one seed) and the
samplers give the same bytes and the same index sequences. The metrics and
the evaluator's report, numpy in the port and scikit-learn in JAX, agree
within 1e-6 on scores with ties. ``run_dual --device cpu`` writes the files
JAX's ``run_dual`` writes, with the same keys.
"""

import json
import os

import numpy as np
import pytest
import torch

from stdd_tpu.data import dataset as jds
from stdd_tpu.data import features as jfeat
from stdd_tpu.eval import best as jbest
from stdd_tpu.models.dual_encoder import DualEncoderAU_LMK as JaxDual
from stdd_tpu.train import metrics as jm
from stdd_tpu.train import samplers as jsamp
from stdd_torch.data import dataset as pds
from stdd_torch.data import features as pfeat
from stdd_torch.eval import best as pbest
from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
from stdd_torch.train import metrics as pm
from stdd_torch.train import run_dual
from stdd_torch.train import samplers as psamp
from stdd_torch.utils.weights import dual_torch_to_flax

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, path="", tol=TOL):
    """Equal structure; numbers within ``tol`` · max(1, |want|), NaN = NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, (list, tuple)) and not (want and isinstance(want[0], (int, float))):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]", tol)
    elif isinstance(want, str):
        assert got == want, path
    else:
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert g.shape == w.shape, path
        assert np.allclose(g, w, rtol=0, atol=tol * max(1.0, float(np.nanmax(np.abs(w)))
                                                         if w.size and not np.isnan(w).all()
                                                         else 1.0), equal_nan=True), (path, g, w)


# -- feature builders -----------------------------------------------------------------

def raw_landmarks(rng, T=6):
    frames = list(rng.uniform(0.1, 0.9, (T, 478, 2)).astype(np.float32))
    frames[2] = None                                    # a nulled frame
    frames[4] = np.zeros((10, 2), np.float32)           # too few points
    seq = np.empty(T, dtype=object)
    seq[:] = frames
    return seq


def test_feature_builders_are_bit_equal_to_jax(tmp_path):
    rng = np.random.RandomState(0)
    seq = raw_landmarks(rng)
    for rot in (False, True):
        got, want = pfeat.lmk_seq_to_features(seq, rot), jfeat.lmk_seq_to_features(seq, rot)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    aus = [{k: float(rng.rand()) for k in jfeat.AU_ORDER} for _ in range(6)]
    arr = rng.rand(7, 12).astype(np.float32)
    for a, kw in ((aus, {}), (arr, {}), (arr, {"use_delta2": False})):
        assert np.array_equal(pfeat.au_seq_to_features(a, **kw), jfeat.au_seq_to_features(a, **kw))

    for side in ("port", "jax"):
        d = tmp_path / side / "FF" / "original" / "v0" / "track_0" / "clip_0"
        os.makedirs(d)
        np.save(d / "landmarks.npy", seq, allow_pickle=True)
        np.save(d / "aus.npy", np.array(aus, dtype=object), allow_pickle=True)
    stats = [mod.process_clip_tree(str(tmp_path / side), rot_invariant=True)
             for mod, side in ((pfeat, "port"), (jfeat, "jax"))]
    assert stats[0] == stats[1] == {"clips": 1, "lmk_ok": 1, "au_ok": 1, "skipped": 0}
    for name in ("lmk_features.npy", "au_features.npy"):
        a, b = ((tmp_path / side / "FF/original/v0/track_0/clip_0" / name).read_bytes()
                for side in ("port", "jax"))
        assert a == b, name
    p = pfeat.compute_norm_stats(str(tmp_path / "port"), str(tmp_path / "p.npz"))
    j = jfeat.compute_norm_stats(str(tmp_path / "jax"), str(tmp_path / "j.npz"))
    P, J = np.load(p), np.load(j)
    assert sorted(P.files) == sorted(J.files)
    assert all(np.array_equal(P[k], J[k]) for k in J.files)


# -- the dataset ------------------------------------------------------------------------

TECHS = (("original", 0), ("deepfakes", 1), ("face2face", 1), ("faceswap", 1))


def build_tree(root, seed=0):
    """Two videos per technique, tracks of 3 clips of 5 to 12 frames, one
    broken landmark file (ejected) and one clip without AUs (skipped)."""
    rng = np.random.RandomState(seed)
    for tech, _ in TECHS:
        for v in range(2):
            for c in range(3):
                d = os.path.join(root, "FF", tech, f"video{v}", "track_0", f"clip_{c}")
                os.makedirs(d)
                n = int(rng.randint(5, 13))
                np.save(os.path.join(d, "au_features.npy"), rng.randn(n, 36).astype(np.float32))
                np.save(os.path.join(d, "lmk_features.npy"), rng.randn(n, 132).astype(np.float32))
    with open(os.path.join(root, "FF", "faceswap", "video1", "track_0", "clip_2",
                           "lmk_features.npy"), "wb") as f:
        f.write(b"not-an-npy")
    os.remove(os.path.join(root, "FF", "face2face", "video0", "track_0", "clip_1",
                           "au_features.npy"))


AUGS = dict(aug_noise_au=0.05, aug_noise_lmk=0.01, aug_tdrop=0.2, lmk_affine_deg=5.0,
            lmk_dropout_p=0.1, au_dropout_p=0.1, lmk_temporal_alpha=0.3, au_temporal_alpha=0.2)


@pytest.mark.parametrize("kw", [dict(is_train=True, **AUGS), dict(is_train=True, stitch_k=2,
                                                                   zscore="global", **AUGS),
                                dict(is_train=False, zscore="none", stitch_k=2, T=16)],
                         ids=["train_clip_z", "train_stitch_global_z", "eval_stitch_raw"])
def test_dataset_load_all_matches_jax(tmp_path, kw):
    """``load_all`` twice (two epochs of augmentation draws), the ids, labels,
    techniques and domains: equal to JAX's for the same seed."""
    build_tree(str(tmp_path))
    kw = dict(kw)
    if kw.get("zscore") == "global":
        kw["norm_stats_path"] = jfeat.compute_norm_stats(str(tmp_path), str(tmp_path / "n.npz"))
    kw.setdefault("T", 8)
    got_ds = pds.DualFeaturesClipDataset(root_dir=str(tmp_path), seed=3, **kw)
    want_ds = jds.DualFeaturesClipDataset(root_dir=str(tmp_path), seed=3, **kw)
    for attr in ("labels", "tech_names", "vid_keys", "track_keys", "domain_map", "n_domains",
                 "au_dim", "lmk_dim"):
        assert getattr(got_ds, attr) == getattr(want_ds, attr), attr
    assert np.array_equal(got_ds.vid_ids, want_ds.vid_ids)
    assert np.array_equal(got_ds.trk_ids, want_ds.trk_ids)
    for _ in range(2):
        got, want = got_ds.load_all(), want_ds.load_all()
        assert got.keys() == want.keys()
        for k in want:
            if k == "tech":
                assert got[k] == want[k]
            else:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# -- samplers -------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(epoch_samples=40), dict(epoch_samples=200, min_quota=3,
                                                             boosts={"faceswap": 3.0}),
                                dict(epoch_samples=12, reshuffle_each_epoch=False),
                                dict(heldout="face2face", epoch_samples=30)],
                         ids=["balanced", "cycled_boosted", "no_reshuffle", "leave_one_out"])
def test_samplers_give_jax_index_sequences(kw):
    rng = np.random.RandomState(1)
    labels = [0] * 23 + [1] * 31
    techs = ["real"] * 23 + list(rng.choice(["deepfakes", "face2face", "faceswap"], 31))
    kw = dict(kw)
    if "heldout" in kw:
        heldout = kw.pop("heldout")
        got = psamp.BalancedPerTechLOOSampler(labels, techs, heldout, seed_base=7, **kw)
        want = jsamp.BalancedPerTechLOOSampler(labels, techs, heldout, seed_base=7, **kw)
    else:
        got = psamp.BalancedPerTechSampler(labels, techs, seed_base=7, **kw)
        want = jsamp.BalancedPerTechSampler(labels, techs, seed_base=7, **kw)
    for epoch in (1, 2, 5):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want), epoch
    assert len(got) == len(want)


# -- metrics ---------------------------------------------------------------------------

def tied_scores(n=60, seed=2):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n).astype(np.float32)
    probs = np.clip(np.round(0.5 + 0.25 * (y - 0.5) + 0.2 * rng.randn(n), 1), 0.1, 0.9)
    return probs, y


@pytest.mark.parametrize("how", ["youden", "balacc", "auc", "acc", "f1", "fpr_0.1", "fpr_0",
                                 "one_class"])
def test_threshold_from_roc_matches_sklearn_version(how):
    probs, y = tied_scores()
    kw = {"metric": how}
    if how.startswith("fpr_"):
        kw = {"target_fpr": float(how[4:])}
    elif how == "one_class":
        y, kw = np.zeros_like(y), {"metric": "youden"}
    with np.errstate(invalid="ignore", divide="ignore"):
        got = pm.threshold_from_roc(probs, y, **kw)
        want = jm.threshold_from_roc(probs, y, **kw)
    assert got[0] == want[0]
    assert_close(got[1], {k: float(v) for k, v in want[1].items()})


def test_temperature_ema_logit_and_aggregation_match_jax():
    probs, y = tied_scores()
    logits = np.log(probs) - np.log1p(-probs)
    assert pm.fit_temperature(logits * 3, y) == jm.fit_temperature(logits * 3, y)
    x = np.random.RandomState(3).randn(4, 6, 5)
    assert np.array_equal(pm.ema_1d(x, 0.3), jm.ema_1d(x, 0.3))
    assert np.array_equal(pm.np_logit(probs), jm.np_logit(probs))
    trk = np.arange(60) // 3
    vid = np.arange(60) // 12
    for a, b in zip(pm.group_median_probs(logits, trk), jm.group_median_probs(logits, trk)):
        assert np.array_equal(a, b)
    for a, b in zip(pm.agg_person_median(logits, y, trk), jm.agg_person_median(logits, y, trk)):
        assert np.array_equal(a, b)
    for a, b in zip(pm.agg_video_noisyor(logits, y, trk, vid),
                    jm.agg_video_noisyor(logits, y, trk, vid)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(mode="acc"), dict(mode="youden"), dict(mode="f1"),
                                dict(target_fpr=0.2), dict(target_fpr=0.0)])
def test_sweep_threshold_matches_jax(kw):
    probs, y = tied_scores(seed=4)
    assert pbest.sweep_threshold(y, probs, **kw) == jbest.sweep_threshold(y, probs, **kw)


def test_global_metrics_and_bootstrap_match_jax():
    probs, y = tied_scores(seed=5)
    preds = (probs >= 0.5).astype(int)
    assert_close(pbest.compute_global_metrics(y, preds, probs),
                 jbest.compute_global_metrics(y, preds, probs))
    assert_close(pbest.compute_global_metrics(np.zeros(5), np.ones(5), probs[:5]),
                 jbest.compute_global_metrics(np.zeros(5), np.ones(5), probs[:5]))
    assert_close(pbest.bootstrap_ci(y, probs, 100, seed=1), jbest.bootstrap_ci(y, probs, 100, seed=1))


def test_evaluate_checkpoint_report_matches_jax(tmp_path):
    """The whole report (clip metrics, per-technique accuracy, video
    aggregation, bootstrap CIs), the port's numpy against JAX's
    scikit-learn, on one model's weights; duplicated clips tie their
    scores."""
    rng = np.random.RandomState(6)
    n, T = 24, 8
    A = rng.randn(n, T, 12).astype(np.float32)
    L = rng.randn(n, T, 20).astype(np.float32)
    A[12:], L[12:] = A[:12], L[:12]                       # ties
    y = (np.arange(n) % 2).astype(np.float32)
    data = {"A": A, "L": L, "y": y, "lengths": np.full(n, T, np.int32)}
    meta = [("real" if yy == 0 else ("deepfakes", "faceswap")[i % 4 // 2], i // 4, i // 2)
            for i, yy in enumerate(y)]
    model = DualEncoderAU_LMK(au_dim=12, lmk_dim=20, d_model=32, depth=1, heads=2, seed=2)
    params = dual_torch_to_flax(model.state_dict(), 2)
    jmodel = JaxDual(au_dim=12, lmk_dim=20, d_model=32, depth=1, heads=2)
    for kw in (dict(threshold=0.5, temperature=1.3, bootstrap=50),
               dict(sweep_mode="youden", agg_mode="track_majority"),
               dict(target_fpr=0.25, agg_mode="track_mean")):
        got = pbest.evaluate_checkpoint(model, None, data, meta, out_path=str(tmp_path / "p.json"),
                                        **kw)
        want = jbest.evaluate_checkpoint(jmodel, params, data, meta,
                                         out_path=str(tmp_path / "j.json"), **kw)
        assert_close(got, want)
        assert_close(json.loads((tmp_path / "p.json").read_text()),
                     json.loads((tmp_path / "j.json").read_text()))


# -- the CLI -----------------------------------------------------------------------------

def make_feature_tree(root, n_videos=10, clips=3, T=8):
    rng = np.random.RandomState(0)
    for vi in range(n_videos):
        tech = ("original", "deepfakes", "original", "faceswap")[vi % 4]
        for ci in range(clips):
            d = os.path.join(root, tech, f"v{vi}", "track_1", f"clip_{ci:05d}")
            os.makedirs(d, exist_ok=True)
            base = 0.0 if tech == "original" else 1.0
            np.save(os.path.join(d, "au_features.npy"), (rng.randn(T, 12) + base).astype(np.float32))
            np.save(os.path.join(d, "lmk_features.npy"), (rng.randn(T, 20) + base).astype(np.float32))


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(v) for v in tree]
    return None


def test_run_dual_on_the_cpu_writes_what_jax_writes(tmp_path):
    """``run_dual --device cpu`` end to end on a tiny tree: the files JAX's
    ``run_dual`` writes, the same keys in each JSON, the same arguments."""
    from stdd_tpu.train.run_dual import main as jax_main

    data = tmp_path / "feats"
    make_feature_tree(str(data))
    argv = ["--data", str(data), "--T", "8", "--d_model", "16", "--layers", "1", "--heads", "2",
            "--epochs", "2", "--batch", "4", "--epoch_samples", "8", "--patience", "2"]
    res = run_dual.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jax_main(argv + ["--out", str(tmp_path / "jax")])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert {"best.msgpack", "report_median.json", "history.json", "args.json"} <= set(files)
    for name in ("args.json", "history.json", "report_median.json"):
        got, want = (json.loads((tmp_path / side / name).read_text()) for side in ("port", "jax"))
        assert _keys(got) == _keys(want), name
    assert (json.loads((tmp_path / "port" / "args.json").read_text())
            == json.loads((tmp_path / "jax" / "args.json").read_text()))
    assert len(res["history"]) == 2 and np.isfinite([h["loss"] for h in res["history"]]).all()


def test_run_dual_needs_the_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        run_dual.main(["--data", str(tmp_path), "--out", str(tmp_path / "out")])
    assert run_dual.build_argparser().parse_args(["--data", "d", "--out", "o"]).device == "cuda"
