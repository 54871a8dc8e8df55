"""The port's training CLI, ``python -m stdd_torch.train.run_i3d``, end to
end on the CPU: one epoch on a clip tree the test writes, its outputs
(``i3d_1.msgpack``, the sidecar, ``best.json``, the log), their use by the
JAX package's checkpoint reader and by the port's scorer, a ``--resume``
that keeps the best epoch of ``best.json``, and the flags it refuses.

The model is the trainer's I3D-R50 at 4×32², batch 2, bf16 compute (the
default), so the test runs the path the card runs, only smaller.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from stdd_tpu.train import engine_i3d as jax_eng
from stdd_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from stdd_torch.config import I3DConfig
from stdd_torch.models.i3d import I3D
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.train import run_i3d
from stdd_torch.utils.weights import i3d_torch_to_flax

T, S = 4, 32
VIDEOS = ["original/000", "original/001", "original/002", "original/003",
          "deepfakes/000_004", "deepfakes/001_005", "deepfakes/002_006", "deepfakes/003_007"]


def write_tree(root):
    """One clip a video; fakes are brighter, a cue to learn."""
    rng = np.random.RandomState(0)
    for vid in VIDEOS:
        shift = 40 if vid.startswith("deepfakes") else 0
        for c in range(1):
            d = os.path.join(root, vid, "track_0", f"clip_{c}")
            os.makedirs(d)
            frames = rng.randint(60, 160, (T, S, S, 3)) + shift
            np.save(os.path.join(d, "images.npy"), frames.astype(np.uint8))
    return root


def cli(tree, out, *extra):
    return ["--data", tree, "--out", out, "--clip_size", str(T), "--crop_size", str(S),
            "--batch", "2", "--epochs", "1", "--warmup_epochs", "1", "--alter_freq", "1",
            "--val_ratio", "0.25", "--precise_bn_batches", "1", "--device", "cpu", *extra]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test processes on this host's cores; one
    torch thread each keeps this module's CPU training from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("run_i3d")
    tree = write_tree(str(base / "tree"))
    out = str(base / "out")
    os.environ["STDD_TRAIN_TIMING"] = "1"
    try:
        state = run_i3d.main(cli(tree, out))
    finally:
        del os.environ["STDD_TRAIN_TIMING"]
    return tree, out, state


def test_one_epoch_writes_checkpoint_sidecar_best_and_log(run):
    tree, out, state = run
    assert state.step >= 2
    files = sorted(os.listdir(out))
    assert {"i3d_1.msgpack", "i3d_1.msgpack.json", "best.json", "log.txt"} <= set(files)
    with open(os.path.join(out, "i3d_1.msgpack.json")) as f:
        assert json.load(f) == {"crop_size": S, "clip_size": T, "temporal_only": False,
                                "epoch": 1}
    with open(os.path.join(out, "best.json")) as f:
        best = json.load(f)
    assert best["best_epoch"] == 0 and best["best_ckpt"] == "i3d_1.msgpack"
    assert 0.0 <= best["best_val_auc"] <= 1.0 and len(best["history"]) == 1
    log = open(os.path.join(out, "log.txt")).read()
    assert '"_type": "train_epoch"' in log and '"_type": "val_epoch"' in log
    assert "timing iter 0: data" in log


def test_checkpoint_loads_in_jax_and_serves_in_the_port(run):
    """The JAX reader takes the port's checkpoint with the JAX trainer's
    state as its target (params, BN statistics and the optax SGD state),
    and the port's scorer serves it at the sidecar's geometry."""
    _, out, state = run
    path = os.path.join(out, "i3d_1.msgpack")
    with torch.device("meta"):
        model = I3D(I3DConfig(num_frames=T, crop_size=S))
    v = i3d_torch_to_flax({k: torch.zeros(()).expand(t.shape) for k, t in
                           model.state_dict().items()})
    params = jax.tree_util.tree_map(np.zeros_like, v["params"])
    args = jax_eng.I3DTrainArgs(grad_clip=1.0, steps_per_epoch=3, max_epoch=1)
    tx = jax_eng.make_i3d_optimizer(params, args, jax_eng.make_lr_schedule(args))
    target = {"params": params, "batch_stats": jax.tree_util.tree_map(np.zeros_like,
                                                                       v["batch_stats"]),
              "opt_state": tx.init(params)}
    tree = jax_load_checkpoint(path, target)
    assert int(tree["opt_state"][3].count) == state.step
    trace = tree["opt_state"][2].trace["s2"]["pathway0_res0"]["branch2"]["a"]["conv"]["kernel"]
    assert np.abs(np.asarray(trace)).max() > 0
    scorer = ClipScorer.from_jax_checkpoint(path, dtype=torch.float32, device="cpu")
    assert (scorer.cfg.num_frames, scorer.cfg.crop_size) == (T, S)
    got = scorer.model.state_dict()["s1.pathway0_stem.conv.weight"]
    assert torch.equal(got, state.params["s1.pathway0_stem.conv.weight"].detach().float())


def test_resume_keeps_the_best_of_best_json(run, tmp_path):
    """A resumed run takes its best from ``best.json``: a better best there
    stays the best, and its checkpoint stays protected from the GC."""
    tree, out, _ = run
    resumed = str(tmp_path / "out")
    os.makedirs(resumed)
    for name in ("i3d_1.msgpack", "i3d_1.msgpack.json"):
        with open(os.path.join(out, name), "rb") as src, \
                open(os.path.join(resumed, name), "wb") as dst:
            dst.write(src.read())
    with open(os.path.join(resumed, "best.json"), "w") as f:
        json.dump({"best_epoch": 0, "best_ckpt": "i3d_1.msgpack", "best_val_auc": 2.0,
                   "history": [{"epoch": 0, "value": 2.0}]}, f)
    state = run_i3d.main(cli(tree, resumed, "--resume", "--epochs", "2", "--max_to_keep", "1"))
    with open(os.path.join(resumed, "best.json")) as f:
        best = json.load(f)
    assert best["best_epoch"] == 0 and best["best_val_auc"] == 2.0
    assert [h["epoch"] for h in best["history"]] == [0, 1]
    assert {"i3d_1.msgpack", "i3d_2.msgpack"} <= set(os.listdir(resumed))
    # the optimizer's count went on from the checkpoint's: one epoch there, one here
    assert state.step > 0 and state.opt_state[-1]["count"] == state.step


@pytest.mark.parametrize("flags,item", [
    (["--mesh"], "item 5"), (["--distributed"], "item 5"),
    (["--coordinator", "localhost:1234"], "item 5"), (["--num_processes", "2"], "item 5"),
    (["--process_id", "0"], "item 5")])
def test_unported_flags_are_refused_by_name(flags, item):
    with pytest.raises(SystemExit, match=item):
        run_i3d.main(["--data", "x", "--out", "y", *flags])


def test_cuda_without_a_card_raises_instead_of_training_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        run_i3d.main(["--data", str(tmp_path), "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
