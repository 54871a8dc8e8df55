"""The port's sweep, variability, AVA and LaTeX-table modules
(``stdd_torch/eval/{sweep,variability,ava,tables}.py``) against the JAX
package's, on inputs made from numpy seeds.

- ``sweep``: ``roc_auc``, ``pr_auc`` and ``sweep_pools`` (every pool method,
  its CSV) within 1e-12.
- ``variability``: the fold of every sample equal to scikit-learn's
  ``StratifiedKFold(shuffle=True)`` (several seeds, class ratios, a class
  smaller than ``n_folds``); ``run_one`` against JAX's scikit-learn-backed
  one within 1e-12, and ``run_seeds``' files.
- ``ava.evaluate_ava`` within 1e-12, the file round trip equal;
  ``tables`` string-equal.
"""

import json
import math
import warnings

import numpy as np
import pytest
from sklearn.model_selection import StratifiedKFold

from stdd_tpu.eval import ava as jax_ava
from stdd_tpu.eval import sweep as jax_sweep
from stdd_tpu.eval import tables as jax_tables
from stdd_tpu.eval import variability as jax_var
from stdd_torch.eval import ava, sweep, tables, variability


def assert_close(got, want, tol=1e-12, path=""):
    """Nested dicts / lists of numbers: equal structure, floats within
    ``tol`` (NaN equal to NaN), everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, got, want)
        for k in want:
            assert_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _scores(rng, n, p_fake=0.5, ties=False):
    y = (rng.rand(n) < p_fake).astype(int)
    s = np.clip(rng.randn(n) * 0.25 + np.where(y == 1, 0.62, 0.38), 0, 1)
    return y, np.round(s, 1) if ties else s


@pytest.mark.parametrize("seed", range(4))
def test_sweep_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    y, s = _scores(rng, 60, ties=seed % 2 == 1)
    assert_close(sweep.roc_auc(y, s), jax_sweep.roc_auc(y, s))
    assert_close(sweep.pr_auc(y, s), jax_sweep.pr_auc(y, s))
    assert math.isnan(sweep.roc_auc(np.ones(3), s[:3]))


def test_sweep_pools_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    per_video, labels = [], []
    for i in range(30):
        fake = i % 2
        per_video.append({t: list(np.clip(rng.randn(int(rng.randint(1, 8))) * 0.15
                                          + (0.65 if fake else 0.35), 0, 1))
                          for t in range(int(rng.randint(0, 3)))})
        labels.append(fake)
    got = sweep.sweep_pools(per_video, labels, 0.5, out_dir=str(tmp_path / "t"), dataset="ffpp")
    want = jax_sweep.sweep_pools(per_video, labels, 0.5, out_dir=str(tmp_path / "j"),
                                 dataset="ffpp")
    assert len(got) == len(sweep.POOL_METHODS) == len(want)
    assert_close(got, want)
    assert (tmp_path / "t" / "summary_all.csv").read_bytes() == \
        (tmp_path / "j" / "summary_all.csv").read_bytes()


# (n, fake share, fake_per_real, n_folds): balanced; skewed; a real class
# smaller than n_folds; three folds
VAR_CASES = [(80, 0.5, 1.0, 5), (120, 0.8, 2.0, 5), (40, 0.93, 3.0, 5), (50, 0.4, 0.7, 3)]


@pytest.mark.parametrize("case", range(len(VAR_CASES)))
def test_stratified_folds_match_sklearn(case):
    n, p_fake, _, n_folds = VAR_CASES[case]
    rng = np.random.RandomState(case)
    for seed in (0, 42, 43, 1234):
        y = (rng.rand(n) < p_fake).astype(int)
        if y[0] == 1 and case % 2:
            y[0] = 0                                   # first-appearance order varies
        want = np.empty(n, int)
        skf = StratifiedKFold(n_splits=n_folds, shuffle=True, random_state=seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")              # a class smaller than n_folds
            for k, (_, test) in enumerate(skf.split(y, y)):
                want[test] = k
        np.testing.assert_array_equal(variability.stratified_kfold_test_folds(y, n_folds, seed),
                                      want)


def test_stratified_folds_refuse_what_sklearn_refuses():
    for y in (np.array([0, 1, 0]), np.array([0, 0, 1, 1, 0, 1])):
        with pytest.raises(ValueError):
            variability.stratified_kfold_test_folds(y, 5, 0)
        with pytest.raises(ValueError):
            list(StratifiedKFold(5, shuffle=True, random_state=0).split(y, y))


@pytest.mark.parametrize("case", range(len(VAR_CASES)))
def test_run_one_matches_jax(case):
    n, p_fake, fake_per_real, n_folds = VAR_CASES[case]
    y, s = _scores(np.random.RandomState(10 + case), n, p_fake, ties=case == 1)
    cfg = variability.VariabilityConfig(threshold=0.45, fake_per_real=fake_per_real,
                                        bootstrap=200, n_folds=n_folds)
    jcfg = jax_var.VariabilityConfig(threshold=0.45, fake_per_real=fake_per_real,
                                     bootstrap=200, n_folds=n_folds)
    for seed in (42, 43):
        got = variability.run_one(y, s, seed, cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_var.run_one(y, s, seed, jcfg)
        assert_close(got, want)
    if case == 2:
        assert any(f.get("single_class") for f in got["per_fold"])


def test_run_seeds_files_match_jax(tmp_path):
    y, s = _scores(np.random.RandomState(5), 100)
    cfg = variability.VariabilityConfig(bootstrap=100, seeds=(42, 43, 44))
    got = variability.run_seeds(y, s, cfg, out_dir=str(tmp_path / "t"))
    want = jax_var.run_seeds(y, s, jax_var.VariabilityConfig(bootstrap=100, seeds=(42, 43, 44)),
                             out_dir=str(tmp_path / "j"))
    assert_close(got, want)
    assert (tmp_path / "t" / "metrics_seeds.csv").read_bytes() == \
        (tmp_path / "j" / "metrics_seeds.csv").read_bytes()
    assert_close(json.load(open(tmp_path / "t" / "summary_variability.json")),
                 json.load(open(tmp_path / "j" / "summary_variability.json")))


def test_load_per_video_csv_matches_jax(tmp_path):
    p = tmp_path / "per_video.csv"
    p.write_text("video_path,gt_label,video_score\n/a,0,0.125\n/b,1,0.875000\n")
    for g, w in zip(variability.load_per_video_csv(str(p)), jax_var.load_per_video_csv(str(p))):
        np.testing.assert_array_equal(g, w)


# -- AVA and tables -----------------------------------------------------------


def _ava_set(rng, n_keys=12, n_classes=4):
    gt_b, gt_l, det_b, det_l, det_s = {}, {}, {}, {}, {}
    for i in range(n_keys):
        key = ava.make_image_key(f"vid{i % 3}", 900 + i)
        g = rng.uniform(0, 0.5, (int(rng.randint(0, 4)), 2))
        boxes = np.concatenate([g, g + rng.uniform(0.1, 0.5, g.shape)], 1)
        gt_b[key], gt_l[key] = boxes.tolist(), rng.randint(1, n_classes + 1, len(boxes)).tolist()
        d = np.concatenate([boxes + rng.normal(0, 0.03, boxes.shape),
                            rng.uniform(0, 1, (int(rng.randint(0, 3)), 4))])
        det_b[key] = d.tolist()
        det_l[key] = rng.randint(1, n_classes + 1, len(d)).tolist()
        det_s[key] = np.round(rng.uniform(0, 1, len(d)), 2).tolist()      # ties
    return gt_b, gt_l, det_b, det_l, det_s


@pytest.mark.parametrize("seed", range(3))
def test_evaluate_ava_matches_jax(seed):
    data = _ava_set(np.random.RandomState(seed))
    excluded = {next(iter(data[0]))} if seed else None
    cats = {1: "walk", 2: "talk", 3: "sit", 4: "stand"}
    got = ava.evaluate_ava(*data, excluded_keys=excluded, categories=cats)
    assert_close(got, jax_ava.evaluate_ava(*data, excluded_keys=excluded, categories=cats))
    assert 0.0 <= got["mAP"] <= 1.0


def test_ava_files_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    gt_b, gt_l, det_b, det_l, det_s = _ava_set(rng)
    (tmp_path / "labelmap.pbtxt").write_text(
        "".join(f'item {{\n  name: "c{c}"\n  id: {c}\n}}\n' for c in (1, 2, 3)))
    with open(tmp_path / "gt.csv", "w") as f:
        for key, boxes in gt_b.items():
            for b, c in zip(boxes, gt_l[key]):
                y1, x1, y2, x2 = b
                f.write(f"{key},{x1:.6f},{y1:.6f},{x2:.6f},{y2:.6f},{c}\n")
    dets = [(*key.split(","), [b[1], b[0], b[3], b[2]], c, s)
            for key in det_b for b, c, s in zip(det_b[key], det_l[key], det_s[key])]
    ava.write_results(dets, str(tmp_path / "t.csv"))
    jax_ava.write_results(dets, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    (tmp_path / "excl.csv").write_text(next(iter(gt_b)) + "\n")
    args = [str(tmp_path / n) for n in ("labelmap.pbtxt", "gt.csv", "t.csv", "excl.csv")]
    assert_close(ava.evaluate_ava_from_files(*args), jax_ava.evaluate_ava_from_files(*args))


def test_tables_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    for run in ("test7", "dual_rgb"):
        (tmp_path / run).mkdir()
        for pool in ("median", "mean"):
            rep = {"clip_metrics": {"auc_roc": rng.rand(), "accuracy": float("nan")},
                   "video_metrics": {"auc_roc": rng.rand(), "accuracy": "n/a"},
                   "per_tech_video_accuracy": {
                       "deep_fakes": {"accuracy": rng.rand(), "videos": 10},
                       "face2face": {"accuracy": rng.rand(), "n": 7}} if pool == "median" else {}}
            with open(tmp_path / run / f"report_{pool}.json", "w") as f:
                json.dump(rep, f)
    pattern = str(tmp_path / "*" / "report_*.json")
    got = tables.generate_tables(pattern, out_path=str(tmp_path / "t.tex"))
    assert got == jax_tables.generate_tables(pattern, out_path=str(tmp_path / "j.tex"))
    assert (tmp_path / "t.tex").read_text() == got
    assert r"deep\_fakes" in got and "--" in got
    rep = json.load(open(tmp_path / "test7" / "report_median.json"))
    assert tables.report_table({"a_b": rep}, "cap", "tab:x") == \
        jax_tables.report_table({"a_b": rep}, "cap", "tab:x")
    assert tables.per_tech_table(rep) == jax_tables.per_tech_table(rep)
