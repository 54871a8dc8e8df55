"""The port's data parallelism (``stdd_torch/parallel``) on the CPU: two gloo
ranks against the JAX package's 8-device mesh (``tests/conftest.py``) and
against the port's own single process.

One module-scoped job of two ranks (this file run as a script, one process
a rank) runs every in-process check and writes what it computed; the tests
read it:

- the I3D AltFreezing step (I3D-R50 at an eighth of the width, 2 frames ×
  16², a global batch of 8, float64) against JAX's step jitted over the
  8-device mesh on the same global batch (loss, BN running statistics and
  parameters after one step within 1e-5, the bound of
  ``test_torch_train.py``), against the port's world-1 step within 1e-10,
  and with dropout on (every rank draws the global batch's mask) too;
- the dual-encoder step of the dry run (AU 4, landmarks 6, d_model 16, one
  layer, Adam at 1e-3, ``slerp`` and ``dat`` off, a global batch of 16,
  float64, dropout off on both sides) against JAX's sharded step within
  1e-5 (``test_torch_dual_train.py``'s bound), and with dropout on against
  the port's world-1 step; then the same step at ``DualTrainArgs``' own
  ``slerp=True, dat=True`` (a domain head of 3 classes, DAT at λ = 0.05,
  one invalid ``dom_id``): against JAX's sharded step given JAX's SLERP
  draws, and with the port's own draws (dropout off and on) against the
  port's world-1 step, the draws themselves equal on every rank;
- sharded serving against the single scorer (1e-6), an indivisible batch
  refused, a checkpoint swap seen;
- ``run_i3d --distributed`` (two processes of one job, each on its stripe
  of the clips): the steps per epoch are the global minimum, rank 0 alone
  writes.

Besides: ``run_i3d --mesh --num_processes 2`` (the CLI starts its two
ranks) ends at the single-process run's checkpoint within the float32
training bound (1e-5; chip_smoke.py's ``TRAIN_F32_TOLS``).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I3D_CFG = dict(num_frames=2, crop_size=16, width_per_group=8)
I3D_ARGS = dict(base_lr=0.04, max_epoch=2, warmup_epochs=1, warmup_start_lr=0.01, alter_freq=2,
                steps_per_epoch=4, grad_clip=1.0)
GB = 8                                 # the I3D step's global batch (one a JAX device)
DUAL_KW = dict(au_dim=4, lmk_dim=6, d_model=16, depth=1, heads=2)
DB, DT = 16, 4                         # the dual step's global batch and frames
# the dual step's variants: the dry run's, and DualTrainArgs' SLERP and DAT
DUAL_VARIANTS = {"plain": (dict(slerp=False, dat=False), {}),
                 "slerp_dat": ({}, dict(use_dat=True, domain_classes=3))}
DAT_LAMBDA = 0.05
TOL = 1e-5
WORLD_TOL = 1e-10
VIDEOS = ["original/000", "original/001", "original/002", "original/003", "original/004",
          "deepfakes/000_005", "deepfakes/001_006", "deepfakes/002_007", "deepfakes/003_008"]


def write_tree(root, T, S):
    """One clip a video, fakes brighter (``test_torch_run_i3d.write_tree``)."""
    rng = np.random.RandomState(0)
    for vid in VIDEOS:
        d = os.path.join(root, vid, "track_0", "clip_0")
        os.makedirs(d)
        frames = rng.randint(60, 160, (T, S, S, 3)) + (40 if vid.startswith("deepfakes") else 0)
        np.save(os.path.join(d, "images.npy"), frames.astype(np.uint8))
    return root


def i3d_batch():
    rng = np.random.RandomState(7)
    return (rng.randn(GB, 2, 16, 16, 3), np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float32))


def dual_batch():
    rng = np.random.RandomState(0)
    dom_id = (np.arange(DB) % 3).astype(np.int32)
    dom_id[5] = -1                               # an invalid id: masked out of DAT
    return {"A": rng.randn(DB, DT, 4), "L": rng.randn(DB, DT, 6),
            "y": (np.arange(DB) % 3 == 0).astype(np.float32), "dom_id": dom_id}


# -- the ranks' side (this file as a script) -----------------------------------------

def _port_i3d(variables, dropout, dp):
    from stdd_torch.config import I3DConfig
    from stdd_torch.models.i3d import I3D
    from stdd_torch.train import altfreeze, engine_i3d as eng
    from stdd_torch.train.step import TrainState
    from stdd_torch.utils.weights import i3d_flax_to_torch

    model = I3D(I3DConfig(**I3D_CFG, dropout_rate=dropout), dtype=torch.float64)
    model.load_state_dict(i3d_flax_to_torch(variables, model))
    model.double()
    args = eng.I3DTrainArgs(**I3D_ARGS)
    params = dict(model.named_parameters())
    tx = eng.make_i3d_optimizer(params, args, eng.make_lr_schedule(args))
    step = eng.make_i3d_train_step(model, tx, altfreeze.i3d_alt_labels(params), args.alter_freq,
                                   dp=dp)
    return model, TrainState.of(model, tx.init(params)), step


def _i3d_steps(dp):
    from stdd_torch.config import I3DConfig
    from stdd_torch.parallel.mesh import local_rows
    from stdd_torch.utils.weights import i3d_torch_to_flax

    from torch_port_helpers import port_i3d_variables

    variables = port_i3d_variables(I3DConfig(**I3D_CFG), seed=0)
    x, y = i3d_batch()
    out = {}
    for dropout in (0.0, 0.5):
        for world, d in ((1, None), (dp.world, dp)):
            model, state, step = _port_i3d(variables, dropout, d)
            xs, ys = (x, y) if d is None else (local_rows(x, dp.rank, world),
                                               local_rows(y, dp.rank, world))
            state, m = step(state, torch.from_numpy(xs), torch.from_numpy(ys), 0)
            v = i3d_torch_to_flax(model.state_dict())
            out[("i3d", dropout, world)] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "acc": float(m["acc"]), "params": v["params"], "batch_stats": v["batch_stats"]}
    return out


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _dual_steps(dp, jax_draws):
    """Each variant's step at world 1 and at ``dp``'s world, dropout off
    and on (the port's own SLERP draws, recorded), and the SLERP-DAT step
    at ``dp``'s world given JAX's draws ``jax_draws`` (dropout off)."""
    from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
    from stdd_torch.parallel.mesh import local_rows
    from stdd_torch.train import engine_dual as eng
    from stdd_torch.train.altfreeze import active_mask_from_labels, dual_labels, dual_phase_active
    from stdd_torch.train.optim import adam
    from stdd_torch.train.step import TrainState
    from stdd_torch.utils.weights import dual_torch_to_flax

    drawn = []
    real_draws = eng.slerp_draws

    def recording(*a, **kw):
        partner, t = real_draws(*a, **kw)
        drawn.append((partner.numpy().copy(), t.numpy().copy()))
        return partner, t

    eng.slerp_draws = recording
    out, batch = {}, dual_batch()
    runs = [(v, dropout, world, None) for v in DUAL_VARIANTS for dropout in (0.0, 0.1)
            for world in (1, dp.world)] + [("slerp_dat", 0.0, dp.world, jax_draws)]
    try:
        for variant, dropout, world, draws in runs:
            d = None if world == 1 else dp
            args_kw, model_kw = DUAL_VARIANTS[variant]
            model = DualEncoderAU_LMK(**DUAL_KW, **model_kw, dropout=dropout)
            model.head_dropout = 2 * dropout
            model.double()
            # a copy: the bridge hands out views of the tensors the step updates
            out.setdefault(("dual_init", variant),
                           _copy(dual_torch_to_flax(model.state_dict(), 2)))
            tx = adam(1e-3)
            params = dict(model.named_parameters())
            state = TrainState(params, {}, tx.init(params), 0)
            args = eng.DualTrainArgs(epochs=1, batch=DB, lr=1e-3, **args_kw)
            step = eng.make_dual_train_step(model, tx, args, dp=d)
            b = {k: torch.from_numpy(v if d is None else local_rows(v, dp.rank, world))
                 for k, v in batch.items()}
            active = active_mask_from_labels(dual_labels(params), dual_phase_active("joint"))
            drawn.clear()
            state, parts = step(state, b, active, DAT_LAMBDA, 0,
                                draws=None if draws is None else tuple(map(torch.from_numpy,
                                                                           draws)))
            key = ("dual", variant, dropout, world) + (() if draws is None else ("jax_draws",))
            out[key] = {"parts": {k: float(v) for k, v in parts.items()},
                        "params": dual_torch_to_flax(model.state_dict(), 2),
                        "draws": list(drawn)}
    finally:
        eng.slerp_draws = real_draws
    return out


def _serving(dp):
    from stdd_torch.config import I3DConfig
    from stdd_torch.ops.align import STD_POINTS_256
    from stdd_torch.parallel.mesh import make_sharded_score_fn
    from stdd_torch.runtime.classifier import ClipScorer

    rng = np.random.RandomState(0)
    B = 4
    crops = rng.randint(0, 255, (B, 4, 96, 96, 3)).astype(np.uint8)
    boxes = np.tile(np.array([5, 5, 90, 90], np.float32), (B, 4, 1))
    lm5 = np.tile((np.asarray(STD_POINTS_256) * 0.3 + 10).astype(np.float32), (B, 4, 1, 1))
    valid = np.array([True, True, False, True])
    scorer = ClipScorer.random_init(cfg=I3DConfig(num_frames=4, crop_size=64, width_per_group=8),
                                    dtype=torch.float32, device="cpu")
    serve = make_sharded_score_fn(scorer, dp)
    out = {"single": scorer.score(crops, boxes, lm5, valid),
           "sharded": serve(crops, boxes, lm5, valid)}
    with pytest.raises(ValueError, match="divisible"):
        serve(crops[:3], boxes[:3], lm5[:3], valid[:3])
    with torch.no_grad():                           # a new checkpoint: all zeros
        for t in scorer.model.state_dict().values():
            t.zero_()
    out["swapped"] = serve(crops, boxes, lm5, valid)
    return {"serving": out}


def _distributed_cli(dp, tree, out_dir):
    from stdd_torch.train import run_i3d
    from stdd_torch.utils import checkpoint

    saves = []
    real = checkpoint.save_checkpoint

    def counting(*a, **kw):
        saves.append(a[2])
        return real(*a, **kw)

    checkpoint.save_checkpoint = counting
    try:
        state = run_i3d.main(["--data", tree, "--out", out_dir, "--clip_size", "2",
                              "--crop_size", "16", "--batch", "2", "--epochs", "2",
                              "--warmup_epochs", "1", "--alter_freq", "1", "--val_ratio", "0.25",
                              "--precise_bn_batches", "4", "--device", "cpu", "--no-bf16",
                              "--distributed", "--num_processes", str(dp.world),
                              "--process_id", str(dp.rank)])
    finally:
        checkpoint.save_checkpoint = real
    return {"cli": {"step": state.step, "saves": saves,
                    "stem": state.params["s1.pathway0_stem.conv.weight"].detach().numpy().copy()}}


def _rank_main(rank, world, port, tree, work):
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from stdd_torch.parallel.mesh import COLLECTIVES, DataParallel, init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
    dp = DataParallel(rank, world)
    res = {}
    res.update(_i3d_steps(dp))
    with np.load(os.path.join(work, "jax_draws.npz")) as f:
        res.update(_dual_steps(dp, (f["partner"], f["t"])))
    res.update(_serving(dp))
    res.update(_distributed_cli(dp, tree, os.path.join(work, "dist_run")))
    res["collectives"] = dict(COLLECTIVES)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# -- the test process's side ---------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks computed (the job runs once a module)."""
    import jax
    import jax.numpy as jnp

    from torch_port_helpers import jax_draws

    work = str(tmp_path_factory.mktemp("mesh"))
    tree = write_tree(os.path.join(work, "tree"), 2, 16)
    with jax.enable_x64(True):
        partner, t = jax_draws(jax.random.PRNGKey(0), 0,
                               jnp.asarray(dual_batch()["y"]).astype(jnp.int32), 0.1, 0.4)
        np.savez(os.path.join(work, "jax_draws.npz"), partner=np.asarray(partner),
                 t=np.asarray(t))
    from stdd_torch.parallel.mesh import free_port

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port), tree, work],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT) for r in (0, 1)]
    try:
        for p in procs:
            log, _ = p.communicate(timeout=600)
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = []
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return tree, work, out


def _tree_err(got, want):
    import jax

    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
               / max(1.0, float(np.abs(np.asarray(b)).max())) for a, b in zip(g, w))


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def test_process_shard_and_local_rows():
    from stdd_torch.parallel.mesh import local_rows, process_shard

    items = [f"clip_{i}" for i in range(103)]
    shards = [process_shard(items, r, 4) for r in range(4)]
    flat = [x for s in shards for x in s]
    assert sorted(flat) == sorted(items) and len(set(flat)) == len(items)
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    assert process_shard(items, 2, 4) == shards[2] == items[2::4]
    with pytest.raises(ValueError):
        process_shard(items, 4, 4)
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(local_rows(x, 1, 3), x[2:4])
    assert local_rows({"x": x}, 2, 3)["x"].tolist() == x[4:].tolist()
    with pytest.raises(ValueError, match="divisible"):
        local_rows(x, 0, 4)


def test_i3d_step_matches_jax_mesh_step(ranks):
    """World 2 against JAX's step jitted over the 8-device mesh with the
    batch on the data axis (its GSPMD BN is the global batch's)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stdd_tpu.config import I3DConfig as JaxI3DConfig
    from stdd_tpu.models.i3d import I3D as JaxI3D
    from stdd_tpu.parallel.mesh import make_mesh
    from stdd_tpu.train import altfreeze as jax_alt
    from stdd_tpu.train import engine_i3d as jax_eng
    from stdd_tpu.train.step import TrainState as JaxTrainState
    from stdd_torch.config import I3DConfig

    from torch_port_helpers import port_i3d_variables

    _, _, out = ranks
    variables = port_i3d_variables(I3DConfig(**I3D_CFG), seed=0)
    x, y = i3d_batch()
    mesh = make_mesh(jax.devices(), data=8, model=1)
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    with jax.enable_x64(True):
        model = JaxI3D(cfg=JaxI3DConfig(**I3D_CFG, dropout_rate=0.0), dtype=jnp.float64)
        args = jax_eng.I3DTrainArgs(**I3D_ARGS)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        params, stats = f64(variables["params"]), f64(variables["batch_stats"])
        tx = jax_eng.make_i3d_optimizer(params, args, jax_eng.make_lr_schedule(args))
        state = JaxTrainState(params, stats, tx.init(params), jnp.zeros((), jnp.int32))
        raw = jax_eng.make_i3d_train_step(model, tx, jax_alt.i3d_alt_labels(params),
                                          args.alter_freq)
        step = jax.jit(getattr(raw, "__wrapped__", raw), in_shardings=(repl, data, data, repl),
                       out_shardings=(repl, repl))
        jstate, jm = step(jax.device_put(state, repl), jax.device_put(jnp.asarray(x), data),
                          jax.device_put(jnp.asarray(y), data), jax.random.PRNGKey(0))
        want = {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
                "params": jax.device_get(jstate.params),
                "batch_stats": jax.device_get(jstate.batch_stats)}
    for rank in out:
        got = rank[("i3d", 0.0, 2)]
        assert _rel(got["loss"], want["loss"]) <= TOL
        assert _rel(got["grad_norm"], want["grad_norm"]) <= TOL
        assert _tree_err(got["params"], want["params"]) <= TOL
        assert _tree_err(got["batch_stats"], want["batch_stats"]) <= TOL


@pytest.mark.parametrize("dropout", [0.0, 0.5], ids=["no_dropout", "dropout"])
def test_i3d_step_at_world_2_is_the_world_1_step(ranks, dropout):
    _, _, out = ranks
    one = out[0][("i3d", dropout, 1)]
    for rank in out:
        two = rank[("i3d", dropout, 2)]
        assert two["acc"] == one["acc"]
        for k in ("loss", "grad_norm"):
            assert _rel(two[k], one[k]) <= WORLD_TOL, k
        for k in ("params", "batch_stats"):
            assert _tree_err(two[k], one[k]) <= WORLD_TOL, k


def _jax_sharded_dual_step(params, variant, draws_key):
    """JAX's dual step (``stdd_tpu/train/engine_dual.py``) jitted over the
    8-device mesh with the global batch on the data axis, from the port's
    initial ``params``, without dropout, float64 → (parts, params)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stdd_tpu.models.dual_encoder import DualEncoderAU_LMK as JaxDual
    from stdd_tpu.parallel.mesh import make_mesh
    from stdd_tpu.train.altfreeze import (active_mask_from_labels, dual_labels,
                                          dual_phase_active)
    from stdd_tpu.train.engine_dual import DualTrainArgs, make_dual_train_step
    from stdd_tpu.train.step import TrainState as JaxTrainState

    from torch_port_helpers import flax_without_dropout

    batch = dual_batch()
    args_kw, model_kw = DUAL_VARIANTS[variant]
    mesh = make_mesh(jax.devices(), data=8, model=1)
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    with flax_without_dropout(), jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        args = DualTrainArgs(epochs=1, batch=DB, lr=1e-3, **args_kw)
        tx = optax.adam(args.lr)
        state = JaxTrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32))
        active = active_mask_from_labels(dual_labels(params), dual_phase_active("joint"))
        raw = make_dual_train_step(JaxDual(**DUAL_KW, **model_kw, dropout=0.0), tx, args)
        step = jax.jit(getattr(raw, "__wrapped__", raw),
                       in_shardings=(repl, {k: data for k in batch}, repl, repl, repl),
                       out_shardings=(repl, repl))
        jb = {k: jax.device_put(jnp.asarray(v), data) for k, v in batch.items()}
        jstate, jparts = step(jax.device_put(state, repl), jb, jax.device_put(active, repl),
                              jax.device_put(jnp.float64(DAT_LAMBDA), repl), draws_key)
        return {k: float(v) for k, v in jparts.items()}, jax.device_get(jstate.params)


def test_dual_dryrun_step_matches_jax_sharded_step(ranks):
    """``__graft_entry__.py:97-133``'s program on the same init and global
    batch, both sides without dropout, float64."""
    import jax

    _, _, out = ranks
    jparts, jparams = _jax_sharded_dual_step(out[0][("dual_init", "plain")], "plain",
                                             jax.random.PRNGKey(0))
    for rank in out:
        got = rank[("dual", "plain", 0.0, 2)]
        for k in ("loss", "main", "align", "uniform"):
            assert _rel(got["parts"][k], jparts[k]) <= TOL, k
        assert "dat" not in got["parts"] and "dat" not in jparts
        assert got["parts"]["acc"] == jparts["acc"]
        assert _tree_err(got["params"], jparams) <= TOL


def test_dual_slerp_dat_step_matches_jax_sharded_step(ranks):
    """``DualTrainArgs``' own SLERP and DAT at world 2 against JAX's step
    jitted over the 8-device mesh on the same init and global batch, the
    port given JAX's SLERP draws (``torch_port_helpers.jax_draws`` of the
    step's key), both sides without dropout, float64; the invalid
    ``dom_id`` is masked out of DAT on both."""
    import jax

    _, _, out = ranks
    jparts, jparams = _jax_sharded_dual_step(out[0][("dual_init", "slerp_dat")], "slerp_dat",
                                             jax.random.PRNGKey(0))
    for rank in out:
        got = rank[("dual", "slerp_dat", 0.0, 2, "jax_draws")]
        assert got["draws"] == []                          # JAX's draws were used
        for k in ("loss", "main", "dat", "align", "uniform"):
            assert _rel(got["parts"][k], jparts[k]) <= TOL, k
        assert got["parts"]["acc"] == jparts["acc"]
        assert _tree_err(got["params"], jparams) <= TOL
    assert jparts["dat"] > 0.5                             # the term is there


@pytest.mark.parametrize("variant,dropout", [
    ("plain", 0.0), ("plain", 0.1), ("slerp_dat", 0.0), ("slerp_dat", 0.1)],
    ids=["no_dropout", "dropout", "slerp_dat-no_dropout", "slerp_dat-dropout"])
def test_dual_step_at_world_2_is_the_world_1_step(ranks, variant, dropout):
    """The batch-coupled terms (alignment, uniformity) see the global batch;
    the encoders' dropout draws the global batch's mask. With SLERP and DAT,
    every rank draws the world-1 step's partners and ``t`` over the global
    labels (the step's generator stands in the same state on each), and DAT
    reads the global ``dom_id``."""
    _, _, out = ranks
    one = out[0][("dual", variant, dropout, 1)]
    assert len(one["draws"]) == (variant == "slerp_dat")
    for rank in out:
        two = rank[("dual", variant, dropout, 2)]
        assert set(two["parts"]) == set(one["parts"])
        for k, v in one["parts"].items():
            assert _rel(two["parts"][k], v) <= WORLD_TOL, k
        assert _tree_err(two["params"], one["params"]) <= WORLD_TOL
        assert len(two["draws"]) == len(one["draws"])
        for (p2, t2), (p1, t1) in zip(two["draws"], one["draws"]):
            assert p2.shape == (DB,) and t2.shape == (DB, 1)
            np.testing.assert_array_equal(p2, p1)
            np.testing.assert_array_equal(t2, t1)


def test_sharded_serving_matches_the_single_scorer_and_sees_a_swap(ranks):
    _, _, out = ranks
    for rank in out:
        s = rank["serving"]
        np.testing.assert_allclose(s["sharded"], s["single"], atol=1e-6)
        assert s["sharded"][2] == 0.0 and np.abs(s["sharded"] - 0.5).max() > 1e-4
        np.testing.assert_allclose(s["swapped"], [0.5, 0.5, 0.0, 0.5], atol=1e-6)
    assert out[0]["collectives"]["all_reduce"] > 0


def test_distributed_cli_takes_the_global_minimum_and_rank_0_writes(ranks):
    from stdd_torch.data.splits import make_split
    from stdd_torch.parallel.mesh import process_shard
    from stdd_torch.train.run_i3d import ensure_val_floor
    import glob

    tree, work, out = ranks
    dirs = sorted(glob.glob(os.path.join(tree, "**", "track_*", "clip_*"), recursive=True))
    split = ensure_val_floor(make_split(dirs, ratios=(0.75, 0.25, 0.0), seed=0), 0.25)
    counts = [len(process_shard(split["train"], r, 2)) for r in (0, 1)]
    assert counts[0] != counts[1]                     # the minimum decides
    steps = min(counts)                               # local batch 1, one window a clip
    assert [r["cli"]["step"] for r in out] == [2 * steps] * 2
    assert out[0]["cli"]["saves"] == [1, 2] and out[1]["cli"]["saves"] == []
    np.testing.assert_array_equal(out[0]["cli"]["stem"], out[1]["cli"]["stem"])
    files = os.listdir(os.path.join(work, "dist_run"))
    assert {"i3d_1.msgpack", "i3d_2.msgpack", "i3d_2.msgpack.json", "log.txt"} <= set(files)
    log = open(os.path.join(work, "dist_run", "log.txt")).read()
    assert "rank 0/2" in log and "rank 1/2" not in log
    assert f"steps/epoch (global min)" in log


def test_mesh_cli_ends_at_the_single_process_checkpoint(tmp_path):
    """``--mesh --device cpu --num_processes 2`` against the same CLI in one
    process, one epoch (3 steps of batch 2, precise-BN, validation), float32
    at 4×64² (BN sees 16 values a channel in s5: at 2×16², 2 values, the
    single-process run alone moves by O(1) with the thread count)."""
    from stdd_torch.train import run_i3d
    from stdd_torch.utils.checkpoint import load_checkpoint

    tree = write_tree(str(tmp_path / "tree"), 4, 64)
    base = ["--data", tree, "--clip_size", "4", "--crop_size", "64", "--batch", "2",
            "--epochs", "1", "--warmup_epochs", "1", "--alter_freq", "1", "--val_ratio", "0.25",
            "--precise_bn_batches", "1", "--device", "cpu", "--no-bf16"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert run_i3d.main(base + ["--out", str(tmp_path / "mesh"), "--mesh",
                                    "--num_processes", "2"]) is None
        run_i3d.main(base + ["--out", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(n)
    got = load_checkpoint(str(tmp_path / "mesh" / "i3d_1.msgpack"))
    want = load_checkpoint(str(tmp_path / "one" / "i3d_1.msgpack"))
    for k in ("params", "batch_stats"):
        assert _tree_err(got[k], want[k]) <= TOL, k
    assert open(str(tmp_path / "mesh" / "best.json")).read() == \
        open(str(tmp_path / "one" / "best.json")).read()


def test_dryrun_multichip_on_the_cpu():
    """The dry run's entry point, asked for the CPU: two new gloo ranks run
    the three programs; the losses are finite, both ranks gather the same
    probs, and K1 and K2 stay unlaunched (their plain versions serve the
    CPU). Without ``device`` it runs on the card."""
    import inspect

    from stdd_torch.parallel.dryrun import dryrun_multichip

    assert inspect.signature(dryrun_multichip).parameters["device"].default == "cuda"
    out = dryrun_multichip(2, "cpu")
    assert len(out) == 2
    for rank in out:
        assert np.isfinite([rank["i3d_loss"], rank["dual_loss"]]).all()
        assert rank["probs"].shape == (4,) and np.isfinite(rank["probs"]).all()
        assert rank["launches"] == {"warp_affine": 0, "fused_bottleneck": 0}
    np.testing.assert_array_equal(out[0]["probs"], out[1]["probs"])


def test_flags_without_a_job_are_refused():
    from stdd_torch.train import run_i3d

    with pytest.raises(SystemExit, match="needs --distributed"):
        run_i3d.main(["--data", "x", "--out", "y", "--process_id", "0", "--device", "cpu"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
