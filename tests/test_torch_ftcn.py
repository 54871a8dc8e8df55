"""The port's FTCN (``stdd_torch/models/ftcn.py``), temporal-only I3D, its
``run_i3d --ftcn`` and the serving of temporal-only checkpoints, against
the JAX package on the CPU.

Weights: the port's initializers with random BN statistics and scales,
carried to a flax tree by ``utils/weights.py::torch_to_flax`` (the JAX
side applies that tree; no JAX init is traced, only ``eval_shape`` checks
that the trees agree). Geometry: ResNet-18 depths at width 8, 8×64² clips,
batch 2 (s4 keeps a 4×4 map, so the random pools have interior sites). The
head keeps FTCN's fixed 16×64 attention and 2048-wide MLP.

Tolerance: float32, ≤ 1e-4 · max(1, max |JAX|) on logits and BN
statistics; train mode runs with the head's dropout off on both sides (a
flax mask cannot be drawn in torch) and the random pools' sites injected
into both. The float32 train step: loss and parameters after the step
≤ 1e-5, the gradients' global norm ≤ 1e-2 (relative; float32 rounding in
two backward passes, as for the I3D step), BN statistics ≤ 2e-5: the
running variance of s4's last block moves by 1.15e-5 of its 2.7 here, the
float32 drift of seven blocks' forward (the two packages reduce the batch
variance in different orders; JAX's ``E[x²] − E[x]²``), while every other
statistic stays within 4.1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.models.ftcn import FTCN as JaxFTCN
from stdd_tpu.models.i3d import I3D as JaxI3D
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.train import altfreeze as jax_alt
from stdd_tpu.train import engine_i3d as jax_eng
from stdd_tpu.train.step import TrainState as JaxTrainState
from stdd_tpu.utils import checkpoint as jax_ckpt
from stdd_torch.config import I3DConfig
from stdd_torch.models.ftcn import FTCN
from stdd_torch.models.i3d import I3D
from stdd_torch.runtime.classifier import ClipScorer, sidecar_config
from stdd_torch.train import altfreeze, engine_i3d as eng, run_i3d
from stdd_torch.train.step import TrainState
from stdd_torch.utils import checkpoint as ckpt
from stdd_torch.utils.weights import (flax_to_torch, i3d_flax_to_torch, i3d_torch_to_flax,
                                      torch_to_flax)

from test_torch_checkpoint import _batch
from torch_port_helpers import flax_without_dropout, max_rel_err, randomize_bn

NARROW = dict(depth=18, width_per_group=8)
TINY = dict(NARROW, num_frames=8, crop_size=64)
B = 2
TOL = 1e-4
STEP_TOLS = {"loss": 1e-5, "batch_stats": 2e-5, "grad_norm": 1e-2, "params": 1e-5}
# (stop_point, patch_type): every patch type, every truncation
CASES = [(3, "time"), (4, "spatial"), (5, "time"), (5, "random"), (5, "random_avg"),
         (5, "all")]
# the cases that also run in train mode (the other pools' train path is
# their eval pool over the batch statistics' activations)
TRAIN_POOLS = ("random", "random_avg")
STEP_CFG = dict(TINY, temporal_only=True, num_frames=4, crop_size=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tree(model, seed: int) -> dict:
    """The port model's initializers with random BN, as a flax tree."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    v = torch_to_flax(model.state_dict())
    rng = np.random.RandomState(seed + 1)
    return {"params": randomize_bn(v["params"], rng),
            "batch_stats": randomize_bn(v["batch_stats"], rng)}


def tree_err(got, want) -> float:
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    return max(max_rel_err(g, w) for g, w in zip(gl, wl))


@pytest.fixture(scope="module")
def clips():
    return np.random.RandomState(3).randn(B, 8, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("stop_point,patch_type", CASES)
def test_ftcn_matches_jax(stop_point, patch_type, clips, monkeypatch):
    """Eval logits; then, for a plain and both random pools, a train-mode
    forward (batch statistics, the running ones moved, ``random_select``
    with the draws injected) on the same tree."""
    cfg = dict(TINY, temporal_only=True, stop_point=stop_point)
    random = patch_type.startswith("random")
    model = FTCN(I3DConfig(**cfg), patch_type=patch_type, random_select=random, patch_k=3)
    v = random_tree(model, seed=stop_point)
    model.load_state_dict(flax_to_torch(v, model))
    jm = JaxFTCN(cfg=JaxI3DConfig(**cfg), patch_type=patch_type, random_select=random,
                 patch_k=3)
    if patch_type == "all":     # the largest head: the trees' shapes agree
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), clips))
        assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == \
            jax.tree_util.tree_map(np.shape, v)
    with torch.no_grad():
        got = model(torch.from_numpy(clips)).numpy()
    assert max_rel_err(got, jax.jit(jm.apply)(v, clips)) <= TOL
    if patch_type not in TRAIN_POOLS:
        return

    # train mode: one site for "random", three for "random_avg"
    sites = {"random": [5], "random_avg": [1, 9, 6]}.get(patch_type)
    if random:
        monkeypatch.setattr(jax.random, "choice", lambda key, a, shape=(), replace=True:
                            jnp.asarray(sites if shape else sites[0]))
    model.head.dropout = 0.0
    with flax_without_dropout():
        want, mut = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1), "patch": jax.random.PRNGKey(2)}))(v, clips)
    got = model(torch.from_numpy(clips), train=True, sites=sites)
    assert max_rel_err(got.detach().numpy(), want) <= TOL
    assert tree_err(torch_to_flax(model.state_dict())["batch_stats"],
                    mut["batch_stats"]) <= TOL


def test_ftcn_draws_its_sites_from_the_generator():
    """Without injected sites the random pools draw interior sites from
    the caller's generator: the same seed, the same logits; ``k`` distinct
    sites for ``random_avg``."""
    cfg = I3DConfig(**TINY, temporal_only=True)
    model = FTCN(cfg, patch_type="random_avg", random_select=True, patch_k=3)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 8, 64, 64, 3).astype(np.float32))
    model.head.dropout = 0.0
    a = model(x, train=True, generator=torch.Generator().manual_seed(5))
    b = model(x, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)


@pytest.mark.parametrize("stop_point", [4, 5])
def test_temporal_only_i3d_matches_jax(stop_point, clips):
    """``I3D(temporal_only)``: 1×1×1 middle convolutions, the stages before
    ``s{stop_point}``; with ``fused_s2`` too, whose blocks stay unfused
    (K2 is never called), as JAX leaves them."""
    cfg = dict(TINY, temporal_only=True, stop_point=stop_point)
    model = I3D(I3DConfig(**cfg))
    model.reset_parameters(torch.Generator().manual_seed(7))
    v = i3d_torch_to_flax(model.state_dict())
    rng = np.random.RandomState(8)
    v = {"params": randomize_bn(v["params"], rng), "batch_stats": randomize_bn(v["batch_stats"], rng)}
    jm = JaxI3D(cfg=JaxI3DConfig(**cfg))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), clips))
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == jax.tree_util.tree_map(np.shape, v)
    assert model.stage_names == ["s2", "s3", "s4"][:stop_point - 2]
    fused = I3D(I3DConfig(**cfg, fused_s2=True))
    fused.load_state_dict(i3d_flax_to_torch(v, fused))
    assert not any(m.fused_eval for m in fused.s2.children())

    def refuse(*a, **k):
        raise AssertionError("K2 called on a spatial_1x1 block")

    want = jax.jit(jm.apply)(v, clips)
    with torch.no_grad():
        got = fused.eval()(torch.from_numpy(clips), bottleneck=refuse)
    assert max_rel_err(got.numpy(), want) <= TOL


def test_alt_labels_on_ftcn_match_jax():
    """FTCN has no [1,k,k] kernel: the spatial group is empty, the [kt>1,1,1]
    kernels (the stem's too) are temporal, the rest both, as JAX labels
    them."""
    model = FTCN(I3DConfig(**TINY, temporal_only=True))
    params = dict(model.named_parameters())
    labels = altfreeze.i3d_alt_labels(params)
    jl = jax_alt.i3d_alt_labels(torch_to_flax(model.state_dict())["params"])
    # the port's labels carried onto the flax tree by the same bridge
    names = list(labels)
    as_tree = torch_to_flax({k: torch.full((1,) * params[k].ndim, float(i))
                             for i, k in enumerate(names)})["params"]
    got = jax.tree_util.tree_map(lambda i: labels[names[int(i.reshape(-1)[0])]], as_tree)
    assert got == jl
    assert "spatial" not in labels.values() and labels["s1.Conv3dBN_0.conv.weight"] == "temporal"


def _step_sides(variables):
    cfg = STEP_CFG
    args = dict(base_lr=0.04, max_epoch=2, warmup_epochs=1, warmup_start_lr=0.01, alter_freq=2,
                steps_per_epoch=4, grad_clip=1.0, lr_policy="step", step_size=1.0)
    model = FTCN(I3DConfig(**cfg))
    model.load_state_dict(flax_to_torch(variables, model))
    model.head.dropout = 0.0
    pa = eng.I3DTrainArgs(**args)
    params = dict(model.named_parameters())
    sched = eng.make_lr_schedule(pa)
    tx = eng.make_i3d_optimizer(params, pa, sched)
    state = TrainState.of(model, tx.init(params))
    step = eng.make_i3d_train_step(model, tx, altfreeze.i3d_alt_labels(params), pa.alter_freq)

    jm = JaxFTCN(cfg=JaxI3DConfig(**cfg))
    ja = jax_eng.I3DTrainArgs(**args)
    jp = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jsched = jax_eng.make_lr_schedule(ja)
    jtx = jax_eng.make_i3d_optimizer(jp, ja, jsched)
    jstate = JaxTrainState(jp, jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                           jtx.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax_eng.make_i3d_train_step(jm, jtx, jax_alt.i3d_alt_labels(jp), ja.alter_freq)
    return model, state, step, jstate, jstep, sched, jsched


def test_ftcn_step_matches_jax(tmp_path):
    """One ``run_i3d --ftcn`` step (SGD, the ftcn solver's ``lr_policy=step``,
    temporal phase) on 2 clips in float32 against JAX's, dropout off; then
    the port's checkpoint of the stepped state read back by JAX's reader
    into the JAX state's tree, optimizer state included."""
    model = FTCN(I3DConfig(**STEP_CFG))
    v = random_tree(model, seed=11)
    rng = np.random.RandomState(12)
    x = rng.randn(2, 4, 32, 32, 3).astype(np.float32)
    y = np.array([0.0, 1.0], np.float32)
    with flax_without_dropout():
        model, state, step, jstate, jstep, sched, jsched = _step_sides(v)
        assert [sched(s) for s in range(9)] == pytest.approx(
            [float(jsched(s)) for s in range(9)], rel=1e-7)
        state, pm = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    got = torch_to_flax(model.state_dict())
    assert max_rel_err(float(pm["loss"]), float(jm["loss"])) <= STEP_TOLS["loss"]
    assert abs(float(pm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= STEP_TOLS["grad_norm"]
    assert tree_err(got["batch_stats"], jstate.batch_stats) <= STEP_TOLS["batch_stats"]
    assert tree_err(got["params"], jstate.params) <= STEP_TOLS["params"]

    opt_to_flax = run_i3d.bridges(model)[2]
    tree = dict(got, opt_state=opt_to_flax(state.opt_state))
    path = ckpt.save_checkpoint(str(tmp_path), "i3d", 1, tree)
    target = {"params": jstate.params, "batch_stats": jstate.batch_stats,
              "opt_state": jstate.opt_state}
    loaded = jax_ckpt.load_checkpoint(path, target)
    jopt = serialization.to_state_dict(jstate.opt_state)
    assert tree_err(serialization.to_state_dict(loaded["opt_state"]), jopt) <= STEP_TOLS["params"]


@pytest.fixture(scope="module")
def ftcn_run(tmp_path_factory):
    """``python -m stdd_torch.train.run_i3d --ftcn`` for one epoch on the
    CPU over ``test_torch_run_i3d``'s clip tree (full width, 4×32², batch
    2, bf16)."""
    from test_torch_run_i3d import cli, write_tree

    base = tmp_path_factory.mktemp("ftcn_run")
    tree = write_tree(str(base / "tree"))
    out = str(base / "out")
    state = run_i3d.main(cli(tree, out, "--ftcn"))
    return out, state


def test_run_i3d_ftcn_trains_and_writes_temporal_only(ftcn_run):
    """The checkpoint holds JAX's ``--ftcn`` tree (the FTCN at the run's
    geometry, its literal-slash block keys, ``opt_state``), the sidecar says
    ``temporal_only``, and a resume reads it back."""
    out, state = ftcn_run
    path = os.path.join(out, "i3d_1.msgpack")
    with open(path + ".json") as f:
        assert json.load(f) == {"crop_size": 32, "clip_size": 4, "temporal_only": True,
                                "epoch": 1}
    raw = ckpt.load_checkpoint(path)
    jm = JaxFTCN(cfg=JaxI3DConfig(num_frames=4, crop_size=32, temporal_only=True))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3))))
    for coll in ("params", "batch_stats"):
        assert jax.tree_util.tree_map(np.shape, raw[coll]) == \
            jax.tree_util.tree_map(lambda a: a.shape, shapes[coll])
    assert "s2/pathway0_res0" in raw["params"] and state.step > 0
    model = FTCN(I3DConfig(num_frames=4, crop_size=32, temporal_only=True))
    fresh = run_i3d.load_train_checkpoint(path, model, TrainState.of(model, state.opt_state))
    for k, t in model.state_dict().items():
        if k in state.params:
            assert torch.equal(t, state.params[k].detach().cpu()), k


def test_ftcn_checkpoint_is_refused_as_jax_refuses_it(ftcn_run):
    """JAX's ``from_jax_checkpoint`` builds an I3D from the sidecar, never
    the FTCN, so the checkpoint its own ``--ftcn`` trainer writes does not
    cover the model: both packages raise the same ``ValueError``."""
    path = os.path.join(ftcn_run[0], "i3d_1.msgpack")
    # JAX's reading of the sidecar gives this config; the I3D it builds is
    # narrowed (ResNet-18 depths, 8 channels a group) only to keep its init
    # cheap: the FTCN's tree lacks the I3D's leaves at any width
    cfg = JaxI3DConfig(num_frames=4, crop_size=32, temporal_only=True, **NARROW)
    with pytest.raises(ValueError, match="does not cover the model"):
        JaxClipScorer.from_jax_checkpoint(path, cfg=cfg)
    with pytest.raises(ValueError, match="does not cover the model") as e:
        ClipScorer.from_jax_checkpoint(path, device="cpu")
    assert "temporal_only=True" in str(e.value)


def test_ftcn_checkpoint_serves_with_arch_ftcn_tt(ftcn_run):
    """``from_jax_checkpoint(path, arch="ftcn_tt")`` serves the checkpoint
    ``run_i3d --ftcn`` writes: the sidecar's geometry, the trained weights
    as they were, the FTCN's forward behind the scorer."""
    out, state = ftcn_run
    path = os.path.join(out, "i3d_1.msgpack")
    ts = ClipScorer.from_jax_checkpoint(path, arch="ftcn_tt", dtype=torch.float32,
                                        device="cpu")
    assert isinstance(ts.model, FTCN) and (ts.cfg.num_frames, ts.cfg.crop_size) == (4, 32)
    sd = ts.model.state_dict()
    for k, t in state.params.items():
        assert torch.equal(sd[k], t.detach().cpu()), k
    crops, boxes, lm5, valid = _batch(np.random.RandomState(5))
    crops, boxes, lm5 = crops[:, :4], boxes[:, :4], lm5[:, :4]
    probs, logits, feats = ts.score_with_features(crops, boxes, lm5, valid)
    assert probs[1] == 0.0 and 0.0 < probs[0] < 1.0 and feats.shape == (2, 1024)


def test_temporal_only_checkpoint_serves_like_jax(tmp_path):
    """A temporal-only I3D checkpoint with its ``temporal_only`` sidecar
    served by the port's ``from_jax_checkpoint`` (through K1's plain
    version on the CPU) and by JAX's ``ClipScorer`` over the same file: the
    same probs, float32."""
    cfg = dict(depth=18, width_per_group=8, num_frames=8, crop_size=64, temporal_only=True,
               stop_point=4)
    model = I3D(I3DConfig(**cfg))
    model.reset_parameters(torch.Generator().manual_seed(21))
    v = i3d_torch_to_flax(model.state_dict())
    rng = np.random.RandomState(22)
    v = {"params": randomize_bn(v["params"], rng), "batch_stats": randomize_bn(v["batch_stats"], rng)}
    path = jax_ckpt.save_checkpoint(str(tmp_path), "i3d", 3, dict(v), metadata={
        "crop_size": 64, "clip_size": 8, "temporal_only": True, "epoch": 3})
    # JAX's scorer over the file's variables (its loader's init is the
    # refusal test's; here only the scoring is compared)
    raw = jax_ckpt.load_checkpoint(path, dict(v))
    js = JaxClipScorer(jax.tree_util.tree_map(jnp.asarray, raw), cfg=JaxI3DConfig(**cfg),
                       dtype=jnp.float32, use_pallas_warp=False)
    ts = ClipScorer.from_jax_checkpoint(path, cfg=I3DConfig(**cfg), dtype=torch.float32,
                                        device="cpu")
    assert ts.model.cfg.temporal_only and ts.model.stage_names == ["s2", "s3"]
    crops, boxes, lm5, valid = _batch(np.random.RandomState(23))
    want = np.asarray(js.score(crops, boxes, lm5, valid))
    got = ts.score(crops, boxes, lm5, valid)
    assert got[1] == 0.0 and 0.0 < got[0] < 1.0
    assert np.abs(got - want).max() <= TOL
    # the sidecar alone gives the port the temporal-only geometry
    meta = sidecar_config(path)
    assert meta.temporal_only and (meta.num_frames, meta.crop_size) == (8, 64)
