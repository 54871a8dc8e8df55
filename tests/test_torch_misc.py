"""The port's ``utils/misc.py`` and ``utils/tracking.py`` against the JAX
package's ``stdd_tpu/utils/misc.py`` and ``stdd_tpu/utils/tracking.py``:
parameter counts over bridged weights, list sharding, subset sampling and
the run tracker's files equal; the flop counter, the sampler and the
profiler scope checked on their own."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from stdd_tpu.utils import misc as jax_misc
from stdd_tpu.utils.tracking import RunTracker as JaxRunTracker
from stdd_torch.config import I3DConfig
from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.utils import misc
from stdd_torch.utils.tracking import RunTracker
from stdd_torch.utils.weights import dual_torch_to_flax, i3d_torch_to_flax


def test_params_count_matches_jax():
    model = ClipScorer.random_init(cfg=I3DConfig(num_frames=8, crop_size=64), device="cpu").model
    variables = i3d_torch_to_flax(model.state_dict())
    n = misc.params_count(model)
    assert n == jax_misc.params_count(variables["params"]) > 27_000_000
    dual = DualEncoderAU_LMK(d_model=32, depth=2, heads=4)
    tree = dual_torch_to_flax(dual.state_dict(), heads=4)
    assert misc.params_count(dual.state_dict()) == misc.params_count(dual) == \
        jax_misc.params_count(tree)


@pytest.mark.parametrize("world", [1, 3, 4])
def test_skip_shard_split_matches_jax(world):
    items = list(range(11))
    shards = [misc.skip_shard_split(items, r, world) for r in range(world)]
    assert shards == [jax_misc.skip_shard_split(items, r, world) for r in range(world)]
    assert sorted(sum(shards, [])) == items


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = (os.path.islink(p), os.path.realpath(p))
    return out


@pytest.mark.parametrize("link", [True, False])
def test_sample_subset_matches_jax(tmp_path, link):
    src = tmp_path / "src"
    rng = np.random.RandomState(0)
    for i in range(9):
        for sub in ("original_sequences/c23", "manipulated_sequences/deepfakes", "misc"):
            p = src / sub / f"v{i}.mp4"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(rng.bytes(8))
    got = misc.sample_subset(str(src), str(tmp_path / "t"), 4, seed=3, link=link)
    want = jax_misc.sample_subset(str(src), str(tmp_path / "j"), 4, seed=3, link=link)
    assert got == want == {"real": 4, "fake": 4}
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(t) == sorted(j)
    for k in t:
        assert t[k][0] == j[k][0] == link
        if link:
            assert t[k][1] == j[k][1]


def test_sample_subset_takes_y4m(tmp_path):
    for lab in ("real", "fake"):
        (tmp_path / "src" / lab).mkdir(parents=True)
        (tmp_path / "src" / lab / "a.y4m").write_bytes(b"YUV4MPEG2")
    assert misc.sample_subset(str(tmp_path / "src"), str(tmp_path / "dst"), 5) == \
        {"real": 1, "fake": 1}


def test_utilization_sampler_collects_samples():
    with misc.UtilizationSampler(period_sec=0.01) as s:
        x = np.zeros(1)
        for _ in range(200_000):
            x += 1
    summary = s.summary()
    assert s.rss_mb and summary["rss_mb_max"] >= summary["rss_mb_mean"] > 0
    assert not s._thread.is_alive()


def test_flop_count_counts_a_call():
    lin = torch.nn.Linear(16, 8)
    assert misc.flop_count(lin, torch.zeros(4, 16)) == 2 * 4 * 16 * 8
    conv = torch.nn.Conv3d(3, 4, (3, 3, 3), padding=1)
    assert misc.flop_count(conv, torch.zeros(1, 3, 2, 5, 5)) == 2 * 4 * 3 * 27 * 2 * 5 * 5
    assert misc.flop_count(lin, torch.zeros(4, 15)) is None


def test_device_numbers_need_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert misc.device_mem_stats() == {}
    with misc.profiler_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]


def test_run_tracker_matches_jax(tmp_path):
    """The same events (but for their ``_t`` time stamps), table and config
    as ``tests/test_utils_misc.py:46`` checks of the JAX tracker."""
    dirs = {}
    for side, cls in (("torch", RunTracker), ("jax", JaxRunTracker)):
        t = cls("proj", name="run1", config={"lr": 1e-3, "tag": object},
                out_dir=str(tmp_path / side), use_wandb=False)
        t.log({"loss": 0.5, "auc": np.float32(0.25)}, step=1)
        t.log({"loss": 0.25})
        t.log_table("scores", ["video", "score"], iter([["a.y4m", 0.9], ["b.y4m", 0.1]]))
        t.finish()
        dirs[side] = t.dir
    events = {}
    for side, d in dirs.items():
        events[side] = [json.loads(line) for line in open(os.path.join(d, "events.jsonl"))]
        for e in events[side]:
            assert isinstance(e.pop("_t"), float)
    assert events["torch"] == events["jax"]
    assert events["torch"][0] == {"_step": 1, "loss": 0.5, "auc": 0.25}
    for f in ("scores.csv", "config.json"):
        assert open(os.path.join(dirs["torch"], f)).read() == \
            open(os.path.join(dirs["jax"], f)).read()
    assert list(csv.reader(open(os.path.join(dirs["torch"], "scores.csv"))))[1] == ["a.y4m", "0.9"]
