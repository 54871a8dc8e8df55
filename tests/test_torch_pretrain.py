"""The port's landmark pretraining (``stdd_torch/train/pretrain.py``) and
``load_feature_clips`` (``stdd_torch/eval/features.py``) against the JAX
package's.

``make_shuffled`` is bit-equal on JAX's uniform keys. Two pretrain steps
run in float64 on both sides (``jax.enable_x64``; the BCE stays float32, as
both packages compute it), dropout 0, the shuffle on JAX's keys, from the
port's ``LMKDisc`` weights (flax's initializers) carried over by the bridge,
at landmarks 10, d_model 16, one layer, two heads, T 6, batch 8: the loss, accuracy and parameters within 1e-5 ·
max(1, max |JAX|) (``test_torch_dual_train.py``'s
``test_steps_match_jax_in_float64``). The remap and the feature windows
are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stdd_tpu.eval.features import load_feature_clips as jax_load_feature_clips
from stdd_tpu.models.dual_encoder import DualEncoderAU_LMK as JaxDual
from stdd_tpu.models.dual_encoder import LMKDisc as JaxDisc
from stdd_tpu.train import pretrain as jpre
from stdd_tpu.train.step import TrainState as JaxTrainState
from stdd_torch.eval.features import load_feature_clips
from stdd_torch.models.dual_encoder import DualEncoderAU_LMK, LMKDisc
from stdd_torch.train import pretrain as ppre
from stdd_torch.train.optim import adamw
from stdd_torch.train.step import TrainState
from stdd_torch.utils.weights import dual_flax_to_torch, dual_torch_to_flax

from torch_port_helpers import max_rel_err

DISC = dict(lmk_dim=10, d_model=16, depth=1, heads=2)
B, T = 8, 6
TOL = 1e-5
LENGTHS = np.array([6, 6, 5, 3, 1, 0, 6, 2])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_shuffled_is_bit_equal_on_jax_keys():
    X = np.random.RandomState(0).randn(B, T, 4).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jpre.make_shuffled(jnp.asarray(X), jnp.asarray(LENGTHS), rng))
    keys = torch.from_numpy(np.array(jax.random.uniform(rng, (B, T))))
    got = ppre.make_shuffled(torch.from_numpy(X), torch.from_numpy(LENGTHS), keys=keys).numpy()
    np.testing.assert_array_equal(got, want)


def test_make_shuffled_keeps_the_set_and_the_padding():
    """The port's own draw (a seeded generator): each row's valid frames
    are a permutation of the input's, the padding stays, rows move."""
    X = np.random.RandomState(1).randn(B, T, 4).astype(np.float32)
    got = ppre.make_shuffled(torch.from_numpy(X), torch.from_numpy(LENGTHS),
                             torch.Generator().manual_seed(0)).numpy()
    for b, n in enumerate(np.maximum(LENGTHS, 1)):            # an all-pad row keeps token 0
        assert {tuple(r) for r in got[b, :n]} == {tuple(r) for r in X[b, :n]}, b
        np.testing.assert_array_equal(got[b, n:], X[b, n:])
    assert not np.array_equal(got[0], X[0])


def test_pretrain_steps_match_jax_in_float64():
    """Two steps of AdamW (lr 3e-4, weight decay 1e-4) from the same
    weights, on JAX's shuffle keys: loss, accuracy and every parameter."""
    rng = np.random.RandomState(2)
    batches = [(rng.randn(B, T, 10), LENGTHS) for _ in range(2)]
    key = jax.random.PRNGKey(5)
    model = LMKDisc(**DISC, dropout=0.0, seed=5).double()
    # a copy: the bridge hands out views of the tensors the port updates in place
    params = jax.tree_util.tree_map(np.array, dual_torch_to_flax(model.state_dict(), 2))
    with jax.enable_x64(True):
        jmodel = JaxDisc(**DISC, dropout=0.0)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        tx = optax.adamw(3e-4)
        jstate = JaxTrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32))
        jstep = jpre.make_pretrain_step(jmodel, tx)
        ptx = adamw(3e-4, ppre.WEIGHT_DECAY)
        named = dict(model.named_parameters())
        state = TrainState(named, {}, ptx.init(named), 0)
        step = ppre.make_pretrain_step(model, ptx)
        for i, (L, lengths) in enumerate(batches):
            shuffle_rng, _ = jax.random.split(jax.random.fold_in(key, i))
            keys = torch.from_numpy(np.array(jax.random.uniform(shuffle_rng, (B, T))))
            jstate, jm = jstep(jstate, jnp.asarray(L), jnp.asarray(lengths), key)
            state, pm = step(state, torch.from_numpy(L), torch.from_numpy(lengths), 5, keys=keys)
            assert max_rel_err(float(pm["loss"]), float(jm["loss"])) <= TOL, i
            assert float(pm["acc"]) == float(jm["acc"]), i
            got = dual_torch_to_flax(state.params, DISC["heads"])
            for path, w in jax.tree_util.tree_leaves_with_path(jstate.params):
                g = got
                for k in path:
                    g = g[k.key]
                assert max_rel_err(g, np.asarray(w)) <= TOL, (i, path)
    assert state.step == 2


def test_pretrain_lmk_epochs_and_batches():
    """``pretrain_lmk`` drops the tail batch, visits ``RandomState(seed +
    ep)``'s order and returns the model's state dict and per-epoch means."""
    rng = np.random.RandomState(3)
    seqs = rng.randn(20, T, 10).astype(np.float32)
    model = LMKDisc(**DISC)
    res = ppre.pretrain_lmk(model, seqs, np.full(20, T), epochs=2, batch=8, seed=1,
                            log=lambda s: None, device="cpu")
    assert [h["epoch"] for h in res["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and 0 <= h["acc"] <= 1 for h in res["history"])
    assert res["params"].keys() == model.state_dict().keys()


def test_remap_pretrained_to_lmk_matches_jax():
    """The pretrained ``enc`` grafted onto the dual model's ``lmk_enc``; a
    dual model whose landmark input is wider keeps its own ``proj``."""
    disc_v = jax.jit(JaxDisc(**DISC).init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 10)))
    disc_sd = dual_flax_to_torch(disc_v["params"])
    kw = dict(au_dim=6, lmk_dim=10, d_model=16, depth=1, heads=2)
    dual10 = jax.tree_util.tree_map(np.asarray, jax.jit(JaxDual(**kw).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 6)), jnp.zeros((1, 4, 10)))["params"])
    for lmk_dim in (10, 12):
        dual = jax.tree_util.tree_map(np.array, dual10)
        if lmk_dim == 12:                      # the tree of a model with 12 landmark inputs
            dual["lmk_enc"]["proj"]["kernel"] = np.random.RandomState(5).randn(
                12, 16).astype(np.float32)
        want = jpre.remap_pretrained_to_lmk(disc_v["params"], dual)
        dual_sd = dual_flax_to_torch(dual, DualEncoderAU_LMK(**dict(kw, lmk_dim=lmk_dim)))
        got = dual_torch_to_flax(ppre.remap_pretrained_to_lmk(disc_sd, dual_sd), 2)
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            g = got
            for k in path:
                g = g[k.key]
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
        moved = got["lmk_enc"]["proj"]["kernel"]
        assert np.array_equal(moved, disc_v["params"]["enc"]["proj"]["kernel"]) is (lmk_dim == 10)


@pytest.mark.parametrize("T_win", [2, 3, 50], ids=["T2", "T3", "empty"])
def test_load_feature_clips_matches_jax(tmp_path, T_win):
    """Non-overlapping windows per track over two dumped files; no window
    at all gives [0, T, 2048]."""
    rng = np.random.RandomState(4)
    paths = []
    for v, tids in enumerate(([0, 0, 1, 0, 1, 1, 0, 2], [3, 3, 3, 3, 3])):
        p = str(tmp_path / f"v{v}.npz")
        np.savez(p, feats=rng.randn(len(tids), 2048).astype(np.float32),
                 tids=np.asarray(tids, np.int64))
        paths.append(p)
    got, want = load_feature_clips(paths, T_win), jax_load_feature_clips(paths, T_win)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["rgb"].shape[1:] == (T_win, 2048)
    assert (len(got["rgb"]) == 0) is (T_win == 50)
