"""The port's landmarker trainer against the JAX package
(``stdd_torch/train/train_landmarker.py`` vs ``stdd_tpu/train/train_landmarker.py``).

- One train step in float64 on both sides, the port given JAX's own draws
  (parameters, renders and augmentation drawn from JAX's key, as the dual
  trainer's parity takes JAX's SLERP draws): loss ≤ 1e-10, Adam's first
  moment (0.1 × the gradient) ≤ 1e-12, the updated parameters ≤ 1e-5 × lr:
  the port's Adam rounds its bias corrections as optax does in float32
  (``1 − 0.999`` is 1.3e-5 off in float32), which optax under ``enable_x64``
  does not, so the first step differs by 6.4e-6 of its size.
- ``optim.adam`` over ``cosine_decay_schedule(lr, steps, alpha=0.1)``
  against optax's over three steps, float32: ≤ 1e-6 × lr on the updates,
  and the schedule at every step ≤ 1e-6 × lr.
- ``holdout_error`` of the packaged landmarker on JAX's held-out draws:
  ≤ 2e-5 (the float32 renders differ by up to 2.5e-4 of a pixel value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import stdd_tpu.models.facemesh as JF
import stdd_tpu.train.train_landmarker as JT
from stdd_torch.models import facemesh as TF
from stdd_torch.train import optim
from stdd_torch.train import train_landmarker as TT
from stdd_torch.utils.weights import flax_to_torch

LR = 3e-4


def test_key_indices_equal():
    np.testing.assert_array_equal(TT._key_indices(), JT._key_indices())


def test_train_step_matches_jax_in_float64():
    batch, width = 3, 8
    jnet = JF.LandmarkNet(width=width)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        canon = jnp.asarray(JF.canonical_mesh(), jnp.float64)
        tx = optax.adam(optax.cosine_decay_schedule(LR, 10, alpha=0.1))
        opt_state = tx.init(jparams)
        step = JT.make_train_step(jnet, tx, canon, jnp.asarray(JT._key_indices()), batch=batch)
        new_params, new_state, loss, (l_param, l_lmk) = step(jparams, opt_state, key)
        # the draws the step made from its key
        @jax.jit
        def draws_of(key):
            kp, kn = jax.random.split(key)
            rigid, theta, style = JF.sample_params(kp, batch, exclude_holdout=True)
            return JF.augment_renders(kn, JF.render_faces(rigid, theta, style)), rigid, theta

        imgs, rigid, theta = draws_of(key)
        draws = [torch.from_numpy(np.array(a, np.float64)) for a in (imgs, rigid, theta)]
        mu = jax.tree_util.tree_map(np.asarray, new_state[0].mu)
        new_params = jax.tree_util.tree_map(np.asarray, new_params)
        loss, l_param, l_lmk = float(loss), float(l_param), float(l_lmk)

    net = TF.LandmarkNet(width=width)
    net.load_state_dict(flax_to_torch(params, net, "landmarker"))
    net.double()
    ttx = optim.adam(optim.cosine_decay_schedule(LR, 10, alpha=0.1))
    state = ttx.init(dict(net.named_parameters()))
    tstep = TT.make_train_step(net, ttx, torch.from_numpy(TF.canonical_mesh()).double(),
                               TT._key_indices(), batch=batch)
    state, tloss, (tp, tl) = tstep(state, draws=draws)
    assert abs(float(tloss) - loss) <= 1e-10 and abs(float(tp) - l_param) <= 1e-10
    assert abs(float(tl) - l_lmk) <= 1e-10
    for name, p in net.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        flax_leaf = "kernel" if leaf == "weight" else "bias"
        want_p = new_params["params"][mod][flax_leaf]
        want_mu = mu["params"][mod][flax_leaf]
        got_p = p.detach().numpy()
        got_mu = state[0]["mu"][name].numpy()
        if got_p.ndim == 4:
            got_p, got_mu = got_p.transpose(2, 3, 1, 0), got_mu.transpose(2, 3, 1, 0)
        elif got_p.ndim == 2:
            got_p, got_mu = got_p.T, got_mu.T
        np.testing.assert_allclose(got_mu, want_mu, atol=1e-12, rtol=0, err_msg=name)
        np.testing.assert_allclose(got_p, want_p, atol=1e-5 * LR, rtol=0, err_msg=name)
    assert state[0]["count"] == 1 and state[1]["count"] == 1


def test_adam_with_cosine_schedule_matches_optax_over_three_steps():
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    jtx = optax.adam(optax.cosine_decay_schedule(LR, 3, alpha=0.1))
    ttx = optim.adam(optim.cosine_decay_schedule(LR, 3, alpha=0.1))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        jp = optax.apply_updates(jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in shapes:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), atol=1e-6 * LR, rtol=0)
    assert ts[0]["count"] == 3 and ts[1]["count"] == 3
    jsched = optax.cosine_decay_schedule(LR, 7, alpha=0.1)
    tsched = optim.cosine_decay_schedule(LR, 7, alpha=0.1)
    for s in range(10):
        assert abs(tsched(s) - float(jsched(jnp.asarray(s, jnp.int32)))) <= 1e-6 * LR
    with pytest.raises(ValueError, match="decay_steps"):
        optim.cosine_decay_schedule(LR, 0)


def test_holdout_error_on_given_draws_matches_jax():
    jl = JF.DenseLandmarker.pretrained()
    tl = TF.DenseLandmarker.pretrained(device="cpu")
    want = JT.holdout_error(jl, n=6, seed=11)
    draws = JF.sample_holdout_params(jax.random.PRNGKey(11), 6)
    got = TT.holdout_error(tl, draws=[torch.from_numpy(np.array(a)) for a in draws])
    assert abs(got - want) <= 2e-5, (got, want)
    assert got < 0.02          # the packaged net inside the held-out bands (JAX: < 0.02)
    assert 0 < TT.holdout_error(tl, n=6) < 0.02


def test_train_saves_what_both_packages_read(tmp_path, capsys):
    lm = TT.main(["--steps", "3", "--batch", "4", "--device", "cpu",
                  "--out", str(tmp_path / "lm.pkl")])
    out = capsys.readouterr().out
    # logged at the first and the last step
    assert "holdout_error" in out and len(lm.history) == 2 and np.isfinite(lm.history).all()
    frame = (np.random.RandomState(0).rand(240, 320, 3) * 255).astype(np.uint8)
    pts = lm(frame, (80, 60, 200, 200))
    again = TF.DenseLandmarker.from_checkpoint(str(tmp_path / "lm.pkl"), device="cpu")
    np.testing.assert_array_equal(again(frame, (80, 60, 200, 200)), pts)
    jl = JF.DenseLandmarker.from_checkpoint(str(tmp_path / "lm.pkl"))
    np.testing.assert_allclose(jl(frame, (80, 60, 200, 200)), pts, atol=0.5)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            TT.main(["--steps", "1", "--out", str(tmp_path / "x.pkl")])
