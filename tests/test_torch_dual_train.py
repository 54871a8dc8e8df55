"""The port's dual-encoder trainer (``stdd_torch/train/engine_dual.py``,
``optim.py``, ``altfreeze.py``) against the JAX package's.

Geometry: AU 12, landmarks 20, d_model 32, 2 layers, 2 heads, T 8, batch
8, the DAT head over 3 domains, dropout 0. The JAX binary head drops out at
a fixed 0.2 whenever it trains, with a mask torch cannot draw, so both
sides run without it (``flax_without_dropout``; the port's
``head_dropout = 0``). The SLERP partners and ``t`` are JAX's draws, passed
to the port.

Tolerances: the schedules within 1e-6 of the peak LR of optax's (float32
there, float64 here: near the end of a one-cycle, where the value is 1e-4
of the peak, float32's cancellation reaches 1e-6 of the value); the AdamW chain within 1e-6 (float32). The train steps run in
float64 on both sides (``jax.enable_x64``; the main BCE stays float32, as
both packages compute it) and hold 1e-5: the loss and the parameters over
max(1, max |JAX|), the gradients' norm relative to it, Adam's ``mu``
(the gradients' trace) and ``nu`` relative to their largest entry over all
parameters. The steps run at the shipped LR, 3e-4: Adam's update
``m̂ / (sqrt(v̂) + 1e-8)`` is ±lr wherever |g| ≫ 1e-8 and turns the float32
BCE's rounding of a gradient near 1e-8 into a share of lr. At lr 3e-3 one
entry of a key kernel (sqrt(v̂) = 2e-9, its first step after a phase swap)
moved 1.09e-5 apart in the two packages, at 3e-4 a tenth of that. ``train_dual`` runs in
float32 on both sides; its history holds 1e-4 (two epochs of float32
steps, then ROC points on 32 validation clips).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from stdd_tpu.models.dual_encoder import DualEncoderAU_LMK as JaxDual
from stdd_tpu.train import altfreeze as jax_alt
from stdd_tpu.train import engine_dual as jax_eng
from stdd_tpu.train.step import TrainState as JaxTrainState
from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
from stdd_torch.train import altfreeze, engine_dual as eng
from stdd_torch.train.step import TrainState
from stdd_torch.utils.msgpack import msgpack_restore
from stdd_torch.utils.weights import (dual_flax_to_torch, dual_opt_state_from_flax,
                                      dual_opt_state_to_flax, dual_torch_to_flax)

from torch_port_helpers import flax_without_dropout, jax_draws, max_rel_err

KW = dict(au_dim=12, lmk_dim=20, d_model=32, depth=2, heads=2, dropout=0.0, use_dat=True,
          domain_classes=3)
B, T = 8, 8
TOL = 1e-5
HISTORY_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_flax_dropout():
    """Every JAX function of this module traces without flax's dropout."""
    with flax_without_dropout():
        yield


def port_model(params=None, dtype=torch.float64, **kw):
    m = DualEncoderAU_LMK(**dict(KW, **kw))
    m.head_dropout = 0.0
    if params is not None:
        m.load_state_dict(dual_flax_to_torch(params, m))
    return m.to(dtype)


def tree_err(got, want) -> float:
    """max over the leaves of ``max_rel_err``."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    return max(max_rel_err(g, w) for g, w in zip(jax.tree_util.tree_leaves(got),
                                                 jax.tree_util.tree_leaves(want)))


def tree_rel(got, want) -> float:
    """max |got − want| over all leaves, over the largest |want| of all
    leaves. (Per leaf, a gradient that is zero but for rounding, such as the
    attention key bias's — softmax ignores a shift — would compare noise
    with noise.)"""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    pairs = list(zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)))
    diff = max(float(np.abs(np.asarray(g, np.float64) - np.asarray(w)).max()) for g, w in pairs)
    return diff / max(float(np.abs(np.asarray(w)).max()) for _, w in pairs)


# -- schedules and the optimizer chain ---------------------------------------------

SCHEDULES = [dict(epochs=5, steps=7), dict(epochs=1, steps=4), dict(epochs=2, steps=10,
             onecycle_pct_start=0.5, onecycle_div_factor=10.0),
             dict(epochs=1, steps=3), dict(epochs=1, steps=6, onecycle_pct_start=0.1),
             dict(epochs=4, steps=5, scheduler="cosine"), dict(epochs=4, steps=5, scheduler="none")]


@pytest.mark.parametrize("case", SCHEDULES, ids=["onecycle", "onecycle_4", "onecycle_pct",
                                                 "fallback_total", "fallback_warm", "cosine",
                                                 "none"])
def test_schedule_matches_optax_at_every_step(case):
    """``make_schedule`` against JAX's, over every step and past the end;
    fewer than 4 steps or a warm leg under one step give the constant LR."""
    case = dict(case)
    steps = case.pop("steps")
    args = dict(lr=3e-4, **case)
    got = eng.make_schedule(eng.DualTrainArgs(**args), steps)
    want = jax_eng.make_schedule(jax_eng.DualTrainArgs(**args), steps)
    total = case["epochs"] * steps
    if callable(want):
        assert callable(got)
        for s in range(total + 3):
            w = float(want(jnp.asarray(s, jnp.int32)))
            assert abs(got(s) - w) <= 1e-6 * args["lr"], (s, got(s), w)
    else:
        assert not callable(got) and got == want == 3e-4


@pytest.mark.parametrize("clip,scheduled", [(1.0, True), (0.0, True), (1.0, False)],
                         ids=["clip_onecycle", "no_clip", "constant_lr"])
def test_adamw_chain_matches_optax(clip, scheduled):
    """``make_dual_optimizer`` (clip or identity → ``adamw``: Adam, decay of
    every parameter, the LR) against optax's chain through each package's
    ``masked_update``, six steps across an AltFreezing A → B swap, with
    gradients above and below the clip norm: the same parameters and the
    same optimizer state, float32, within 1e-6."""
    params = {k: v.detach().clone() for k, v in port_model(dtype=torch.float32).named_parameters()}
    jparams = jax.tree_util.tree_map(np.array, dual_torch_to_flax(params, 2))
    args = dict(epochs=2, lr=3e-2, wd=1e-2, clip_grad=clip,
                scheduler="onecycle" if scheduled else "none")
    tx = eng.make_dual_optimizer(eng.DualTrainArgs(**args),
                                 eng.make_schedule(eng.DualTrainArgs(**args), 3))
    jargs = jax_eng.DualTrainArgs(**args)
    jtx = optax.chain(optax.clip_by_global_norm(clip) if clip else optax.identity(),
                      optax.adamw(jax_eng.make_schedule(jargs, 3), weight_decay=jargs.wd))
    state, jstate = tx.init(params), jtx.init(jparams)
    labels, jlabels = altfreeze.dual_labels(params), jax_alt.dual_labels(jparams)
    jupdate = jax.jit(lambda g, s, p, m: jax_alt.masked_update(jtx, g, s, p, m))
    rng = np.random.RandomState(0)
    for step in range(6):
        phase = "A" if step < 3 else "B"
        scale = 3.0 if step % 2 else 0.01
        grads = {k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * scale)
                 for k, p in params.items()}
        state = altfreeze.masked_update(
            tx, grads, state, params,
            altfreeze.active_mask_from_labels(labels, altfreeze.dual_phase_active(phase)))
        jparams, jstate = jupdate(
            dual_torch_to_flax(grads, 2), jstate, jparams,
            jax_alt.active_mask_from_labels(jlabels, jax_alt.dual_phase_active(phase)))
        assert tree_err(dual_torch_to_flax(params, 2), jparams) <= 1e-6, step
        opt = dual_opt_state_to_flax(state, 2)
        jopt = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate))
        assert tree_err(opt, jopt) <= 1e-6, step
    # and back: optax's state into the port's layout
    again = dual_opt_state_from_flax(jopt, tx.init(params))
    assert tree_err(dual_opt_state_to_flax(again, 2), jopt) == 0.0


def test_labels_and_phases_match_jax():
    """Each parameter's label equals JAX's at the same flax path; the
    phases and their trained labels equal JAX's for several schedules."""
    params = dict(port_model().named_parameters())
    names = list(params)
    labels = altfreeze.dual_labels(params)
    # each flax leaf of the bridge holds the index of the parameter it came from
    where = dual_torch_to_flax({n: torch.full(tuple(params[n].shape), float(i))
                                for i, n in enumerate(names)}, 2)
    name_at = jax.tree_util.tree_map(lambda a: names[int(a.flat[0])], where)
    assert (jax.tree_util.tree_map(lambda n: labels[n], name_at)
            == jax_alt.dual_labels(dual_torch_to_flax(params, 2)))
    assert set(labels.values()) == {"au", "lmk", "other"}
    for cfg in (altfreeze.AltFreezeCfg(), altfreeze.AltFreezeCfg(warmup_epochs=1, period=1),
                altfreeze.AltFreezeCfg(enabled=False), altfreeze.AltFreezeCfg(start_epoch=3)):
        jcfg = jax_alt.AltFreezeCfg(**vars(cfg))
        for last in (4, 10):
            phases = [altfreeze.dual_phase(cfg, e, last) for e in range(1, last + 1)]
            assert phases == [jax_alt.dual_phase(jcfg, e, last) for e in range(1, last + 1)]
            for ph in set(phases):
                assert altfreeze.dual_phase_active(ph) == jax_alt.dual_phase_active(ph)


# -- the train step ----------------------------------------------------------------

def batch_arrays(seed):
    rng = np.random.RandomState(seed)
    return {"A": rng.randn(B, T, 12), "L": rng.randn(B, T, 20),
            "y": np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float32),
            "lengths": np.array([8, 6, 8, 3, 1, 8, 0, 5], np.int32),
            "dom_id": np.array([0, 1, 2, 0, 2, 0, 0, 1], np.int32),
            "trk": np.array([0, 0, 1, 1, 2, 3, 3, 3])}


def test_slerp_math_matches_jax_on_its_draws():
    z = np.random.RandomState(2).randn(8, 16).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    y = np.array([0, 1, 1, 0, 1, 0, 0, 1])
    key = jax.random.PRNGKey(4)
    want = jax_eng._slerp_same_class(jnp.asarray(z), jnp.asarray(y), 0.1, 0.4, key)
    k1, k2 = jax.random.split(key)
    same = y[:, None] == y[None, :]
    partner = jnp.argmax(jnp.where(same, jax.random.gumbel(k1, (8, 8)), -jnp.inf), axis=1)
    t = jax.random.uniform(k2, (8, 1), minval=0.1, maxval=0.4)
    got = eng.slerp_same_class(torch.from_numpy(z), torch.from_numpy(np.array(partner)),
                               torch.from_numpy(np.array(t)))
    assert max_rel_err(got.numpy(), want) <= 1e-6
    # the port's own draws: same-class partners, t in [0.1, 0.4)
    p, tt = eng.slerp_draws(torch.from_numpy(y), 0.1, 0.4, torch.Generator().manual_seed(0))
    assert (y[p.numpy()] == y).all() and ((tt >= 0.1) & (tt < 0.4)).all()


STEP_VARIANTS = {
    "base": dict(),
    "every_term": dict(focal=True, train_agg="track", aux_pred_w=0.3, aux_con_w=0.2,
                       attn_entropy=0.1, attn_agree=0.05),
}


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_steps_match_jax_in_float64(variant):
    """Three steps (two in AltFreezing phase A, then B) with SLERP on
    JAX's draws, DAT at λ = 0.05, alignment and uniformity, masked lengths
    with an all-pad row; ``every_term`` adds the focal loss on per-track
    noisy-OR logits, the aux heads' LMK→AU and InfoNCE terms and the
    attention terms. After each step: loss, gradients' norm, parameters
    and Adam's moments as JAX's; the frozen branch bit-identical."""
    aux = variant == "every_term"
    args = dict(epochs=2, batch=B, wd=1e-3, **STEP_VARIANTS[variant])     # the shipped lr
    model = port_model(aux_heads=aux)
    # a copy: the bridge hands out views of the tensors the port updates in place
    params = jax.tree_util.tree_map(np.array, dual_torch_to_flax(model.state_dict(), 2))
    pargs, jargs = eng.DualTrainArgs(**args), jax_eng.DualTrainArgs(**args)
    tx = eng.make_dual_optimizer(pargs, eng.make_schedule(pargs, 4))
    named = dict(model.named_parameters())
    state = TrainState(named, {}, tx.init(named), 0)
    step = eng.make_dual_train_step(model, tx, pargs)
    labels = altfreeze.dual_labels(state.params)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        jmodel = JaxDual(**KW)
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jtx = optax.chain(optax.clip_by_global_norm(jargs.clip_grad),
                          optax.adamw(jax_eng.make_schedule(jargs, 4), weight_decay=jargs.wd))
        jstate = JaxTrainState(jparams, {}, jtx.init(jparams), jnp.zeros((), jnp.int32))
        jstep = jax_eng.make_dual_train_step(jmodel, jtx, jargs)
        jlabels = jax_alt.dual_labels(jparams)
        for i, phase in enumerate(("A", "A", "B")):
            data = batch_arrays(10 + i)
            active = altfreeze.dual_phase_active(phase)
            jb = {k: jnp.asarray(v) for k, v in data.items() if k != "trk"}
            pb = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items() if k != "trk"}
            if STEP_VARIANTS[variant].get("train_agg"):
                grp = np.unique(data["trk"], return_inverse=True)[1]
                jb["grp"], pb["grp"] = jnp.asarray(grp), torch.from_numpy(grp)
            draws = jax_draws(key, i, jb["y"].astype(jnp.int32), *jargs.slerp_range)
            frozen = [k for k, lab in labels.items() if lab not in active]
            before = {k: state.params[k].clone() for k in frozen}
            state, pm = step(state, pb, altfreeze.active_mask_from_labels(labels, active),
                             0.05, 0, draws=tuple(torch.from_numpy(np.asarray(d)) for d in draws))
            jstate, jm = jstep(jstate, jb, jax_alt.active_mask_from_labels(jlabels, active),
                               0.05, key)
            assert max_rel_err(float(pm["loss"]), float(jm["loss"])) <= TOL, i
            for k in ("main", "dat", "align", "uniform", "aux_pred", "aux_con",
                      "attn_entropy", "attn_agree"):
                assert (k in pm) == (k in jm), k
                if k in pm:
                    assert max_rel_err(float(pm[k]), float(jm[k])) <= TOL, (i, k)
            assert abs(float(pm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= TOL, i
            assert float(pm["acc"]) == float(jm["acc"])
            got_p = dual_torch_to_flax(state.params, 2)
            assert tree_err(got_p, jstate.params) <= TOL, i
            opt = dual_opt_state_to_flax(state.opt_state, 2)
            jopt = serialization.to_state_dict(jstate.opt_state)
            adam, jadam = opt["1"]["0"], jopt["1"]["0"]
            assert int(adam["count"]) == int(jadam["count"]) == i + 1
            assert tree_rel(adam["mu"], jadam["mu"]) <= TOL, i
            assert tree_rel(adam["nu"], jadam["nu"]) <= TOL, i
            for k in frozen:
                assert torch.equal(state.params[k], before[k]), (i, k)
    assert state.step == 3


# -- the training loop ----------------------------------------------------------------

def synth(n, seed):
    """Separable clips: fakes carry a frame-rate flicker in a few channels."""
    rng = np.random.RandomState(seed)
    y = ((np.arange(n) // 4) % 2).astype(np.float32)       # tracks of 2, videos of 4 clips
    A = rng.randn(n, T, 12).astype(np.float32) * 0.5
    L = rng.randn(n, T, 20).astype(np.float32) * 0.5
    flicker = ((-1.0) ** np.arange(T))[None, :, None]
    A[y == 1, :, :3] += 0.6 * flicker
    L[y == 1, :, :5] += 0.6 * flicker
    return {"A": A, "L": L, "y": y, "dom_id": (y * rng.randint(1, 3, n)).astype(np.int32),
            "lengths": np.where(np.arange(n) % 5 == 0, 5, T).astype(np.int32),
            "trk": np.arange(n) // 2, "vid": np.arange(n) // 4}


def test_train_dual_matches_jax_and_checkpoints_cross(tmp_path):
    """``train_dual`` for 2 epochs of 4 steps from JAX's initial weights
    (``PRNGKey(seed)``), float32, dropout 0, ``slerp=False``, DAT on: the
    same history, temperature, calibrated threshold and test metrics, the
    same output files; the port's ``best.msgpack`` scored by the JAX model
    and JAX's by the port, within 1e-5."""
    train, val, test = synth(64, 0), synth(32, 1), synth(32, 2)
    args = dict(epochs=2, batch=16, lr=3e-3, slerp=False, es_warmup=0, seed=5)
    jmodel = JaxDual(**KW)
    jres = jax_eng.train_dual(jmodel, train, val, jax_eng.DualTrainArgs(**args),
                              out_dir=str(tmp_path / "jax"), test_data=test, log=lambda s: None)
    init = jmodel.init(jax.random.PRNGKey(5), jnp.zeros((1, T, 12)), jnp.zeros((1, T, 20)))
    model = port_model(jax.tree_util.tree_map(np.asarray, init["params"]), torch.float32)
    res = eng.train_dual(model, train, val, eng.DualTrainArgs(**args),
                         out_dir=str(tmp_path / "port"), test_data=test, log=lambda s: None)

    assert len(res["history"]) == len(jres["history"]) == 2
    for h, jh in zip(res["history"], jres["history"]):
        assert h.keys() == jh.keys()
        assert (h["epoch"], h["phase"]) == (jh["epoch"], jh["phase"])
        for k in ("loss", "val_auc", "val_acc", "thr"):
            assert abs(h[k] - jh[k]) <= HISTORY_TOL * max(1.0, abs(jh[k])), (k, h, jh)
    for k in ("best_val_auc", "best_threshold", "temperature", "threshold_calibrated"):
        assert abs(res[k] - jres[k]) <= HISTORY_TOL * max(1.0, abs(jres[k])), k
    assert res["test"].keys() == jres["test"].keys()
    for k, v in jres["test"].items():
        assert abs(res["test"][k] - v) <= HISTORY_TOL, k

    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    for name in ("args.json", "history.json"):
        a, b = (json.loads((tmp_path / side / name).read_text()) for side in ("port", "jax"))
        assert (a.keys() == b.keys()) if name == "args.json" else (
            [r.keys() for r in a] == [r.keys() for r in b])
    args_json = json.loads((tmp_path / "port" / "args.json").read_text())
    assert args_json == json.loads((tmp_path / "jax" / "args.json").read_text())

    # checkpoints cross: each package scores the other's best.msgpack
    A, L, lengths = val["A"], val["L"], val["lengths"]
    port_blob = msgpack_restore((tmp_path / "port" / "best.msgpack").read_bytes())
    j_logits = jmodel.apply({"params": port_blob}, A, L, lengths=jnp.asarray(lengths))["bin_logits"]
    with torch.no_grad():
        p_logits = model(torch.from_numpy(A), torch.from_numpy(L),
                         torch.from_numpy(lengths))["bin_logits"]
    assert max_rel_err(p_logits.numpy(), j_logits) <= TOL
    jax_blob = serialization.msgpack_restore((tmp_path / "jax" / "best.msgpack").read_bytes())
    other = port_model(jax_blob, torch.float32)
    with torch.no_grad():
        p2 = other(torch.from_numpy(A), torch.from_numpy(L), torch.from_numpy(lengths))
    want = jmodel.apply({"params": jres["params"]}, A, L, lengths=jnp.asarray(lengths))
    assert max_rel_err(p2["bin_logits"].numpy(), want["bin_logits"]) <= TOL
