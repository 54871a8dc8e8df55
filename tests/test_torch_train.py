"""The port's I3D AltFreezing trainer (``stdd_torch/train``) against the JAX
package's (``stdd_tpu/train``).

Geometry: the JAX trainer tests' ``TINY`` (``I3DConfig(num_frames=4,
crop_size=32)``), all 50 layers at an eighth of the width
(``width_per_group=8``: 8 to 256 channels, 0.4M parameters), batch 2,
dropout off (a JAX mask cannot be drawn in torch; dropout has its own
test). Weights: the port's initializers with
random BN (``torch_port_helpers.port_i3d_variables``), one numpy tree that
builds both packages' train states.

Tolerance: ≤ 1e-5 · max(1, max |reference|) on the loss, the gradients'
global norm, every parameter, every BN running statistic and the optimizer
state. The step-for-step comparisons run the network in float64 on both
sides (``jax.enable_x64``; the heads and the loss stay float32, as the JAX
model computes them). In float32 the rounding of a 50-layer train-mode
backward reaches 1.5e-4 of the largest gradient here and 1.9e-3 at 8×64²
and full width (the port's own float32 against float64 gradients), and the
two packages' float32 gradient norms differ by 3.0e-4, so no 1e-5 bound
holds a float32 step (``scripts/torch_train_precision.py`` measures all
three). The float32 train-mode forward is held to JAX's by the precise-BN
test (1e-4), and a float32 step on the card to the same step on the CPU
by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization


from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.models.i3d import I3D as JaxI3D
from stdd_tpu.train import altfreeze as jax_alt
from stdd_tpu.train import engine_i3d as jax_eng
from stdd_tpu.train import lr_policy as jax_lr
from stdd_tpu.train.losses import bce_with_logits as jax_bce
from stdd_tpu.train.metrics import metrics_from_logits as jax_metrics
from stdd_tpu.train.step import TrainState as JaxTrainState
from stdd_tpu.utils import checkpoint as jax_ckpt
from stdd_torch.config import I3DConfig
from stdd_torch.models.i3d import I3D
from stdd_torch.train import altfreeze, engine_i3d as eng, lr_policy
from stdd_torch.train.losses import bce_with_logits
from stdd_torch.train.metrics import metrics_from_logits
from stdd_torch.train.run_i3d import load_train_checkpoint
from stdd_torch.train.step import TrainState
from stdd_torch.utils.checkpoint import save_checkpoint
from stdd_torch.utils.weights import (i3d_flax_to_torch, i3d_opt_state_to_flax,
                                      i3d_torch_to_flax)

from torch_port_helpers import max_rel_err, port_i3d_variables

CFG = dict(num_frames=4, crop_size=32, width_per_group=8, dropout_rate=0.0)
B = 2
TOL = 1e-5
# bf16 step against the float32 step, over max(1, max |float32|): on three
# batches at this geometry at most 2.7e-3 in the loss, 6.0e-2 in the BN
# statistics (the variance of s5's 1-frame, 1×1 activations) and 7.1e-4 in
# the parameters after one step at the warmup LR
# (scripts/torch_train_precision.py); the bounds are about 3× that. (The
# gradients' norm moved by 5-22%: at batch 2 the stem's gradient is largely
# bf16 rounding; the clip at norm 1 keeps the step small.)
BF16_TOLS = {"loss": 1e-2, "batch_stats": 0.2, "params": 2.5e-3}


def args_for(optimizer="sgd", **kw):
    base = dict(base_lr=0.04, max_epoch=2, warmup_epochs=1, warmup_start_lr=0.01,
                alter_freq=2, steps_per_epoch=4, grad_clip=1.0, optimizer=optimizer)
    base.update(kw)
    return base


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test processes on this host's cores; one
    torch thread each keeps this module's CPU steps from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    return port_i3d_variables(I3DConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.RandomState(7)
    return [(rng.randn(B, 4, 32, 32, 3).astype(np.float32),
             np.array([0.0, 1.0], np.float32)[rng.permutation(2)]) for _ in range(5)]


# -- the two sides -------------------------------------------------------------

def port_side(variables, compute=torch.float64, **kw):
    """The port's model computing in ``compute`` (its parameters float64
    for a float64 model, else float32), state and step."""
    model = I3D(I3DConfig(**CFG), dtype=compute)
    model.load_state_dict(i3d_flax_to_torch(variables, model))
    model.to(torch.float64 if compute == torch.float64 else torch.float32)
    args = eng.I3DTrainArgs(**args_for(**kw))
    params = dict(model.named_parameters())
    sched = eng.make_lr_schedule(args)
    tx = eng.make_i3d_optimizer(params, args, sched)
    state = TrainState.of(model, tx.init(params))
    step = eng.make_i3d_train_step(model, tx, altfreeze.i3d_alt_labels(params), args.alter_freq)
    return model, state, step


def jax_side(variables, f64=True, **kw):
    """The JAX model, state and jitted step over the same tree (float64
    arrays and compute when ``f64``; call it inside ``jax.enable_x64``)."""
    dt = np.float64 if f64 else np.float32
    model = JaxI3D(cfg=JaxI3DConfig(**CFG), dtype=jnp.float64 if f64 else jnp.float32)
    args = jax_eng.I3DTrainArgs(**args_for(**kw))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), variables["params"])
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), variables["batch_stats"])
    sched = jax_eng.make_lr_schedule(args)
    tx = jax_eng.make_i3d_optimizer(params, args, sched)
    state = JaxTrainState(params, stats, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_eng.make_i3d_train_step(model, tx, jax_alt.i3d_alt_labels(params),
                                       args.alter_freq)
    return model, state, step


def port_trees(model, state):
    """The port's params, BN statistics and optimizer state as the JAX
    trainer's trees."""
    v = i3d_torch_to_flax(model.state_dict())
    return v["params"], v["batch_stats"], i3d_opt_state_to_flax(state.opt_state)


def tree_err(got, want) -> float:
    """max over leaves of ``max_rel_err``, without float64 copies of the
    leaves (27M parameters a tree at this geometry)."""
    worst = 0.0
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        worst = max(worst, float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max())))
    return worst


def compare(model, state, pm, jstate, jm, tol=TOL):
    """Every number of the two states and steps' metrics within ``tol``."""
    params, stats, opt = port_trees(model, state)
    jopt = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate.opt_state))
    assert max_rel_err(float(pm["loss"]), float(jm["loss"])) <= tol
    assert max_rel_err(float(pm["grad_norm"]), float(jm["grad_norm"])) <= tol
    assert float(pm["acc"]) == float(jm["acc"])
    assert pm["phase_temporal"] == float(jm["phase_temporal"])
    assert tree_err(params, jstate.params) <= tol
    assert tree_err(stats, jstate.batch_stats) <= tol
    assert jax.tree_util.tree_structure(opt) == jax.tree_util.tree_structure(jopt)
    for k in opt:
        for field, v in opt[k].items():
            if field == "count":
                assert int(v) == int(jopt[k][field])
            elif field != "inner_state":
                assert tree_err(v, jopt[k][field]) <= tol, (k, field)
    assert state.step == int(jstate.step)


def as_port(x, dtype):
    return torch.from_numpy(x).to(dtype)


# -- losses, schedules, labels -------------------------------------------------

def test_bce_with_logits_matches_jax_and_keeps_its_shape_check():
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 1).astype(np.float32) * 4
    y = rng.randint(0, 2, 6).astype(np.float32)
    for lg, kw in ((logits, {}), (logits[:, 0], {}), (logits[:, 0], {"pos_weight": 2.5}),
                   (logits[:, 0], {"reduction": "sum"})):
        got = bce_with_logits(torch.from_numpy(lg), torch.from_numpy(y), **kw)
        want = jax_bce(jnp.asarray(lg), jnp.asarray(y), **kw)
        assert max_rel_err(got.numpy(), np.asarray(want)) <= 1e-6
    for lg, yy in ((logits, y[:3]), (logits[:, 0], y[:, None]), (np.zeros((6, 2)), y)):
        with pytest.raises(ValueError):
            bce_with_logits(torch.from_numpy(lg), torch.from_numpy(yy))


@pytest.mark.parametrize("policy", ["cosine", "step"])
def test_lr_table_matches_jax(policy):
    kw = dict(base_lr=0.04, lr_policy=policy, max_epoch=12, warmup_epochs=3,
              warmup_start_lr=0.01, step_size=4, gamma=0.3, steps_per_epoch=7)
    got = eng.make_lr_schedule(eng.I3DTrainArgs(**kw))
    want = jax_eng.make_lr_schedule(jax_eng.I3DTrainArgs(**kw))
    for s in range(12 * 7 + 5):                      # past the end reads the last entry
        assert got(s) == float(want(jnp.asarray(s))), s
    sw = lr_policy.steps_with_relative_lrs(0.1, [0, 30, 60], [1.0, 0.1, 0.01], 90)
    jsw = jax_lr.steps_with_relative_lrs(0.1, [0, 30, 60], [1.0, 0.1, 0.01], 90)
    assert [sw(e) for e in range(0, 95, 5)] == [jsw(e) for e in range(0, 95, 5)]
    with pytest.raises(ValueError):
        lr_policy.steps_with_relative_lrs(0.1, [30, 60], [0.1, 0.01], 90)


def test_alt_labels_and_phase_masks_match_jax(variables):
    """The port's label of every parameter, and its phase mask at steps 0
    to 4·alter_freq, equal JAX's at the same flax path."""
    params = dict(I3D(I3DConfig(**CFG)).named_parameters())
    labels = altfreeze.i3d_alt_labels(params)
    jlabels = jax_alt.i3d_alt_labels(variables["params"])
    names = list(params)
    # each flax leaf of the bridge holds the index of the parameter it came from
    where = i3d_torch_to_flax({n: torch.full(tuple(params[n].shape), float(i))
                               for i, n in enumerate(names)})["params"]
    name_at = jax.tree_util.tree_map(lambda a: names[int(a.flat[0])], where)
    assert jax.tree_util.tree_map(lambda n: labels[n], name_at) == jlabels
    assert {"temporal", "spatial", "both"} == set(labels.values())
    for step in range(4 * 2 + 1):
        mask = altfreeze.i3d_phase_mask(labels, step, 2)
        jmask = jax_alt.i3d_phase_mask(jlabels, jnp.asarray(step), 2)
        assert (jax.tree_util.tree_map(lambda n: mask[n], name_at)
                == jax.tree_util.tree_map(float, jmask)), step


# -- the optimizer chain alone ------------------------------------------------------

CHAIN_PARAMS = {                                  # one leaf of each kind the labels tell apart
    "s1.pathway0_stem.conv.weight": (4, 3, 5, 7, 7),
    "s1.pathway0_stem.bn.weight": (4,), "s1.pathway0_stem.bn.bias": (4,),
    "s2.pathway0_res0.branch2.a.conv.weight": (6, 4, 3, 1, 1),
    "s2.pathway0_res0.branch2.b.conv.weight": (6, 6, 1, 3, 3),
    "s2.pathway0_res0.branch2.c.conv.weight": (8, 6, 1, 1, 1),
    "head.projection.weight": (1, 8), "head.projection.bias": (1,),
}


@pytest.mark.parametrize("kw", [
    {}, {"nesterov": True}, {"dampening": 0.3}, {"bn_weight_decay": 1e-3},
    {"grad_clip": None}, {"optimizer": "adam"}, {"optimizer": "adam", "grad_clip": None}],
    ids=["sgd", "nesterov", "dampening", "bn_decay", "no_clip", "adam", "adam_no_clip"])
def test_optimizer_chain_matches_optax(kw):
    """Every option of ``make_i3d_optimizer`` against the JAX chain (optax)
    through ``masked_update``, six AltFreezing steps at ``alter_freq=1`` with
    gradients above and below the clip norm: the same parameters and the
    same optimizer state in float32."""
    rng = np.random.RandomState(0)
    params = {k: torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1)
              for k, shape in CHAIN_PARAMS.items()}
    # a copy: the bridge hands out views of the tensors the port updates in place
    jparams = jax.tree_util.tree_map(np.array, i3d_torch_to_flax(params)["params"])
    args = args_for(alter_freq=1, steps_per_epoch=3, **kw)
    targs, jargs = eng.I3DTrainArgs(**args), jax_eng.I3DTrainArgs(**args)
    tx = eng.make_i3d_optimizer(params, targs, eng.make_lr_schedule(targs))
    jtx = jax_eng.make_i3d_optimizer(jparams, jargs, jax_eng.make_lr_schedule(jargs))
    state, jstate = tx.init(params), jtx.init(jparams)
    labels = altfreeze.i3d_alt_labels(params)
    jlabels = jax_alt.i3d_alt_labels(jparams)
    for step in range(6):
        scale = 3.0 if step % 2 else 0.01                  # above, then below the clip norm
        grads = {k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * scale)
                 for k, p in params.items()}
        state = altfreeze.masked_update(tx, grads, state, params,
                                        altfreeze.i3d_phase_mask(labels, step, 1))
        jparams, jstate = jax_alt.masked_update(
            jtx, i3d_torch_to_flax(grads)["params"], jstate, jparams,
            jax_alt.i3d_phase_mask(jlabels, jnp.asarray(step), 1))
        assert tree_err(i3d_torch_to_flax(params)["params"], jparams) <= 1e-6, step
        opt, jopt = i3d_opt_state_to_flax(state), serialization.to_state_dict(jstate)
        assert jax.tree_util.tree_structure(opt) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, jopt))
        assert tree_err(opt, jopt) <= 1e-6, step


# -- train steps ----------------------------------------------------------------

def _group(labels, lab):
    return [k for k, v in labels.items() if v == lab]


def test_sgd_steps_match_jax_across_a_phase_swap(variables, batches, tmp_path):
    """Four SGD steps at ``alter_freq=2`` (temporal, temporal, spatial,
    spatial), then a checkpoint of either package resumed in the other: the
    same state after every step, the frozen group bit-identical with its
    momentum still JAX's, and the next step equal both ways."""
    model, state, step = port_side(variables)
    labels = altfreeze.i3d_alt_labels(state.params)
    with jax.enable_x64(True):
        jmodel, jstate, jstep = jax_side(variables)
        rng = jax.random.PRNGKey(0)
        for i, (x, y) in enumerate(batches[:4]):
            frozen = _group(labels, "spatial" if i < 2 else "temporal")
            before = {k: state.params[k].clone() for k in frozen}
            state, pm = step(state, as_port(x, torch.float64), torch.from_numpy(y), 0)
            jstate, jm = jstep(jstate, jnp.asarray(x, jnp.float64), jnp.asarray(y), rng)
            compare(model, state, pm, jstate, jm)
            for k in frozen:
                assert torch.equal(state.params[k], before[k]), (i, k)
            if i == 1:
                # frozen for two steps, the spatial group's momentum holds
                # wd·p, as JAX's does (compare above)
                trace = state.opt_state[2]["trace"]
                assert all(trace[k].abs().max() > 0 for k in frozen)

        # port checkpoint → JAX; JAX checkpoint → port; one more step each
        tree = i3d_torch_to_flax(model.state_dict())
        tree["opt_state"] = i3d_opt_state_to_flax(state.opt_state)
        p_path = save_checkpoint(str(tmp_path / "port"), "i3d", 1, tree)
        target = {"params": jstate.params, "batch_stats": jstate.batch_stats,
                  "opt_state": jstate.opt_state}
        loaded = jax_ckpt.load_checkpoint(p_path, target)
        cast = lambda a: jnp.asarray(a, jnp.float64) if np.asarray(a).dtype.kind == "f" \
            else jnp.asarray(a)
        loaded = jax.tree_util.tree_map(cast, loaded)
        j_from_port = JaxTrainState(loaded["params"], loaded["batch_stats"],
                                    loaded["opt_state"], jstate.step)
        j_path = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "i3d", 1, target)
        p_model, p_state, p_step = port_side(variables)
        p_state = load_train_checkpoint(j_path, p_model, p_state)
        p_state.step = state.step
        x, y = batches[4]
        state, pm = step(state, as_port(x, torch.float64), torch.from_numpy(y), 0)
        j_next, jm = jstep(j_from_port, jnp.asarray(x, jnp.float64), jnp.asarray(y), rng)
        compare(model, state, pm, j_next, jm)
        j_next, jm = jstep(jstate, jnp.asarray(x, jnp.float64), jnp.asarray(y), rng)
        p_state, pm = p_step(p_state, as_port(x, torch.float64), torch.from_numpy(y), 0)
        compare(p_model, p_state, pm, j_next, jm)


def test_adam_step_matches_jax(variables, batches):
    """One Adam step. Its update is ``m̂ / (sqrt(v̂) + 1e-8)``, about ±lr
    wherever |g| ≫ 1e-8, so a gradient of the order of that epsilon turns
    rounding into ~lr·δg/1e-8: at the trainer's warmup LR of 0.01 float64
    rounding moves parameters by 1.2e-6, at 0.001 by 1.2e-7
    (``scripts/torch_train_precision.py``); the test steps at 0.001."""
    kw = dict(optimizer="adam", weight_decay=1e-3, base_lr=0.004, warmup_start_lr=0.001)
    model, state, step = port_side(variables, **kw)
    x, y = batches[0]
    with jax.enable_x64(True):
        _, jstate, jstep = jax_side(variables, **kw)
        state, pm = step(state, as_port(x, torch.float64), torch.from_numpy(y), 0)
        jstate, jm = jstep(jstate, jnp.asarray(x, jnp.float64), jnp.asarray(y),
                           jax.random.PRNGKey(0))
        compare(model, state, pm, jstate, jm)
    assert state.opt_state[1]["count"] == 1


def test_bf16_step_stays_near_the_float32_step(variables, batches):
    """bf16 compute over float32 parameters (the trainer's default) against
    the float32 step, port against port."""
    x, y = batches[0]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        model, state, step = port_side(variables, compute=dt)
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
        out[dt] = (float(m["loss"]),) + port_trees(model, state)[:2]
    (l32, p32, s32), (l16, p16, s16) = out[torch.float32], out[torch.bfloat16]
    assert max_rel_err(l16, l32) <= BF16_TOLS["loss"]
    assert tree_err(s16, s32) <= BF16_TOLS["batch_stats"]
    assert tree_err(p16, p32) <= BF16_TOLS["params"]
    assert tree_err(p16, p32) > 0                    # the bf16 step did compute in bf16


def test_dropout_keeps_and_scales_like_flax():
    torch.manual_seed(0)
    cfg = I3DConfig(**dict(CFG, dropout_rate=0.5))
    model = I3D(cfg)
    out = model.head.projection
    feats = torch.rand(64, out.in_features) + 0.5
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        out.weight.copy_(torch.eye(1, out.in_features))
        out.bias.zero_()
    dropped = []
    for _ in range(4):
        # the head's dropout is applied to the features before the projection
        kept = model.head.forward(feats, train=True, generator=g)[:, 0]
        dropped.append(kept)
    kept = torch.stack(dropped)
    zero = kept == 0
    assert 0.4 < zero.float().mean() < 0.6
    assert torch.allclose(kept[~zero], (feats[:, 0] / 0.5).expand_as(kept)[~zero])
    assert torch.equal(model.head.forward(feats)[:, 0], feats[:, 0])          # eval: identity
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(model.head.forward(feats, train=True, generator=g2)[:, 0], dropped[0])
    with pytest.raises(ValueError):
        model.head.forward(feats, train=True)


def test_precise_bn_matches_jax(variables, batches):
    clips = [x + 3.0 for x, _ in batches[:3]]
    model, state, _ = port_side(variables, compute=torch.float32)
    state = eng.precise_bn_update(model, state, [torch.from_numpy(c) for c in clips])
    jmodel, jstate, _ = jax_side(variables, f64=False)
    jstate = jax_eng.precise_bn_update(jmodel, jstate, [jnp.asarray(c) for c in clips])
    _, stats, _ = port_trees(model, state)
    assert tree_err(stats, jstate.batch_stats) <= 1e-4
    stem = stats["s1"]["pathway0_stem"]["bn"]["mean"]
    assert np.abs(stem - variables["batch_stats"]["s1"]["pathway0_stem"]["bn"]["mean"]).max() > 0.01
    assert all(bn.momentum == 0.1 for bn in model.modules() if isinstance(bn, torch.nn.BatchNorm3d))


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ties", "one_class", "nan_logits", "all_positive"])
def test_metrics_match_the_sklearn_version(case):
    rng = np.random.RandomState(1)
    logits = np.round(rng.randn(40) * 2, 1)                  # many tied scores
    y = rng.randint(0, 2, 40).astype(np.float32)
    if case == "one_class":
        y[:] = 0
    elif case == "all_positive":
        y[:] = 1
    elif case == "nan_logits":
        logits[[3, 7, 11]] = np.nan
        logits[5] = np.inf
    got = metrics_from_logits(logits, y)
    with np.errstate(over="ignore"):
        want = jax_metrics(logits, y)
    for k in ("tn", "fp", "fn", "tp", "TPR", "FPR", "balacc", "youden", "acc", "f1", "pr_auc"):
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k
    np.testing.assert_array_equal(got["probs"], want["probs"])
    if np.isnan(want["roc_auc"]):
        assert np.isnan(got["roc_auc"])
    else:
        assert got["roc_auc"] == pytest.approx(float(want["roc_auc"]), abs=1e-12)


def test_topk_helpers_equal_jax_on_tied_scores():
    """``topks_correct``, ``topk_accuracies`` and ``topk_errors`` on scores
    with ties (rounded to one decimal, 6 classes): equal to JAX's, the
    stable descending order deciding the tied ranks."""
    from stdd_tpu.train import metrics as jax_m
    from stdd_torch.train import metrics as m

    rng = np.random.RandomState(3)
    preds = np.round(rng.randn(50, 6), 1)
    preds[:5] = 0.5                                          # whole rows tied
    labels = rng.randint(0, 6, 50)
    ks = (1, 2, 5)
    for fn in ("topks_correct", "topk_accuracies", "topk_errors"):
        got, want = getattr(m, fn)(preds, labels, ks), getattr(jax_m, fn)(preds, labels, ks)
        assert got == want, fn
    assert m.topks_correct(preds[:5], np.arange(5), (1,)) == [1.0]    # only class 0 wins a tie
    with pytest.raises(ValueError, match="Batch dim"):
        m.topks_correct(preds, labels[:-1], ks)
