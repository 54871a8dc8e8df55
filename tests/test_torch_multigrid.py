"""The port's multigrid schedule (``stdd_torch/train/multigrid.py``) against
the JAX package's (``stdd_tpu/train/multigrid.py``), and its on-card runner
``python -m stdd_torch.train.measure_multigrid`` run on the CPU at JAX's
smoke configuration (``scripts/measure_train_epoch.py --smoke``'s
contract).

The schedules are equal for the default, the short-cycle and the smoke
configurations: the table, ``max_epoch``, ``long_cycle_shape`` and
``update`` at every epoch, ``short_cycle_spatial`` and ``lr_boundaries``
(whose leading 0 the port's step policy takes)."""

import json

import pytest
import torch

from stdd_tpu.train import multigrid as jax_mg
from stdd_torch.train import measure_multigrid as mm
from stdd_torch.train import multigrid as mg
from stdd_torch.train.lr_policy import steps_with_relative_lrs

SMOKE = dict(default_b=2, default_t=8, default_s=32, solver_steps=(0, 2, 3),
             solver_max_epoch=4, epoch_factor=1.0)
CONFIGS = {"default": {}, "short_cycle": dict(short_cycle=True), "smoke": SMOKE,
           "other_steps": dict(solver_steps=(0, 10, 20, 25), solver_max_epoch=40,
                                       gamma=0.5, base_lr=0.2)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_schedule_equals_jax(name):
    ours = mg.MultigridSchedule(mg.MultigridConfig(**CONFIGS[name]))
    theirs = jax_mg.MultigridSchedule(jax_mg.MultigridConfig(**CONFIGS[name]))
    assert ours.schedule == theirs.schedule and ours.max_epoch == theirs.max_epoch
    prev_o = prev_t = None
    for e in range(ours.max_epoch + 3):
        assert ours.long_cycle_shape(e) == theirs.long_cycle_shape(e)
        (so, co), (st, ct) = ours.update(e, prev_o), theirs.update(e, prev_t)
        assert so == st and co == ct
        prev_o, prev_t = so, st
    for it in range(7):
        for s in (158, 224, 23):
            assert ours.short_cycle_spatial(it, s) == theirs.short_cycle_spatial(it, s)
    steps, lrs = ours.lr_boundaries()
    assert (steps, lrs) == theirs.lr_boundaries()
    assert steps[0] == 0 and len(steps) == len(lrs)
    pol = steps_with_relative_lrs(1.0, steps, lrs, max_epoch=steps[-1] + 10)
    assert pol(0.0) == pytest.approx(lrs[0]) and pol(steps[-1] + 5) == pytest.approx(lrs[-1])


def test_make_batch_is_seeded_and_separable():
    g = torch.Generator().manual_seed(3)
    clips, y = mm.make_batch(g, 6, 5, 7, "cpu")
    again, y2 = mm.make_batch(torch.Generator().manual_seed(3), 6, 5, 7, "cpu")
    assert clips.shape == (6, 5, 7, 7, 3) and y.shape == (6,) and clips.dtype == torch.float32
    assert torch.equal(clips, again) and torch.equal(y, y2)
    c, lab = mm.make_batch(torch.Generator().manual_seed(4), 64, 6, 4, "cpu")
    assert 0 < lab.sum() < 64 and torch.isfinite(c).all()
    assert set(lab.tolist()) == {0.0, 1.0}


def test_smoke_run_on_the_cpu(tmp_path, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rec = mm.main(["--smoke", "--device", "cpu", "--steps_per_epoch", "1",
                       "--precise_bn_batches", "1", "--eval_batches", "2",
                       "--out", str(tmp_path)])
    finally:
        torch.set_num_threads(n)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(rec))
    assert rec["metric"] == "multigrid_long_cycle_epoch" and rec["smoke_cpu"] is True
    assert rec["schedule_epochs"] == 4 and rec["total_steps"] == 4
    assert rec["losses_finite"] and rec["resume_drill"]["bitwise_identical"] is True
    assert rec["resume_drill"]["restored_step"] == rec["resume_drill"]["step"]
    shapes = {tuple(s["shape"]) for s in rec["shapes"]}
    assert shapes == {(16, 2, 23), (8, 4, 23), (4, 4, 32)}
    for s in rec["shapes"]:
        assert (s["steps_per_s"] is None) == (s["ms_per_step"] is None)
    assert rec["precise_bn_stem_moved"] > 0 and 0.0 <= rec["eval_auc_after_precise_bn"] <= 1.0


def test_stops_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mm.main(["--steps_per_epoch", "1"])
