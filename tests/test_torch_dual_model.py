"""The port's dual encoder (``stdd_torch/models/dual_encoder.py``), its
weight bridge and the dual losses (``stdd_torch/train/losses.py``) against
the JAX package's.

Geometry: AU 12, landmarks 20, d_model 32, 2 layers, 2 heads, T 8, batch 8,
with the DAT head (5 domains) and the aux heads. The weights are the JAX
model's own initializers (one jitted ``init``), carried to the port by
``dual_flax_to_torch``. Tolerances: the float32 forward within
1e-5 · max(1, max |JAX|) on every output; the losses and their gradients
within 1e-6 (float32, a few ops each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.models import dual_encoder as jde
from stdd_tpu.train import losses as jl
from stdd_torch.models import dual_encoder as pde
from stdd_torch.train import losses as pl
from stdd_torch.utils.weights import dual_flax_to_torch, dual_torch_to_flax

from torch_port_helpers import max_rel_err

KW = dict(au_dim=12, lmk_dim=20, d_model=32, depth=2, heads=2, use_dat=True, domain_classes=5)
B, T = 8, 8
TOL = 1e-5
LOSS_TOL = 1e-6
# [B] lengths with a full, a short, a one-token and an all-pad row; the same
# as a [B, T] validity mask, with its own all-zero row
LENGTHS = np.array([8, 7, 3, 1, 0, 8, 5, 2])
VALID = (np.arange(T)[None, :] < np.array([8, 0, 3, 1, 6, 8, 5, 2])[:, None]).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    return jde.DualEncoderAU_LMK(**KW)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return rng.randn(B, T, 12).astype(np.float32), rng.randn(B, T, 20).astype(np.float32)


@pytest.fixture(scope="module")
def variables(jax_model, inputs):
    A, L = inputs
    init = jax.jit(lambda key, A, L: jax_model.init(key, A, L, lengths=jnp.asarray(LENGTHS),
                                                    need_aux=True))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), A, L))


@pytest.fixture(scope="module")
def port_model(variables):
    m = pde.DualEncoderAU_LMK(**KW, aux_heads=True)
    m.load_state_dict(dual_flax_to_torch(variables["params"], m))
    return m


@pytest.fixture(scope="module")
def jax_apply(jax_model):
    @jax.jit
    def apply(v, A, L, lengths, dat_lambda):
        return jax_model.apply(v, A, L, lengths=lengths, need_aux=True, return_z=True,
                               return_seq=True, dat_lambda=dat_lambda)

    return apply


def _flat(out):
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        elif v is not None:
            flat[k] = v
    return flat


@pytest.mark.parametrize("mask", ["none", "lengths", "validity"])
def test_forward_matches_jax(mask, variables, port_model, jax_apply, inputs):
    """Every output of the full forward, bridged weights, float32:
    ``bin_logits``, ``dom_logits``, ``z``, both sequences, both pooling
    weights, the aux heads and the pad mask; with no mask, [B] lengths and
    a [B, T] validity mask, each with an all-pad row."""
    A, L = inputs
    lengths = {"none": None, "lengths": LENGTHS, "validity": VALID}[mask]
    want = _flat(jax_apply(variables, A, L, None if lengths is None else jnp.asarray(lengths),
                           0.3))
    with torch.no_grad():
        got = _flat(port_model(torch.from_numpy(A), torch.from_numpy(L),
                               None if lengths is None else torch.from_numpy(lengths),
                               need_aux=True, return_z=True, return_seq=True, dat_lambda=0.3))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype == bool:
            assert np.array_equal(g, np.asarray(w)), k
        else:
            assert max_rel_err(g, w) <= TOL, (k, max_rel_err(g, w))
    if lengths is not None:
        # an all-pad row attends to token 0 only, and stays finite
        w_au = got["weights.au"].numpy()
        row = 4 if mask == "lengths" else 1
        assert w_au[row, 0] == pytest.approx(1.0) and np.isfinite(got["bin_logits"].numpy()).all()


def test_z_override_runs_the_heads_alone(variables, port_model, jax_model):
    """``z_override``: the heads (binary and reversed domain) on a given
    embedding, as the trainer scores a SLERP-augmented one."""
    z = np.random.RandomState(1).randn(B, 64).astype(np.float32)
    want = jax_model.apply(variables, None, None, z_override=jnp.asarray(z), dat_lambda=0.5)
    with torch.no_grad():
        got = port_model(z_override=torch.from_numpy(z), dat_lambda=0.5)
    assert max_rel_err(got["bin_logits"].numpy(), want["bin_logits"]) <= TOL
    assert max_rel_err(got["dom_logits"].numpy(), want["dom_logits"]) <= TOL


def test_lmk_disc_matches_jax(inputs):
    _, L = inputs
    jm = jde.LMKDisc(lmk_dim=20, d_model=32, depth=2, heads=2)
    port = pde.LMKDisc(lmk_dim=20, d_model=32, depth=2, heads=2)
    params = dual_torch_to_flax(port.state_dict(), heads=2)      # the port's draw, bridged
    port.load_state_dict(dual_flax_to_torch(params, port))
    for lengths in (None, LENGTHS):
        want = jm.apply({"params": params}, L,
                        lengths=None if lengths is None else jnp.asarray(lengths))
        with torch.no_grad():
            got = port(torch.from_numpy(L), None if lengths is None else torch.from_numpy(lengths))
        assert max_rel_err(got.numpy(), want) <= TOL


def test_bridge_round_trip_and_refusals(variables, port_model):
    """flax → torch → flax gives the flax tree back bit for bit, and the
    port's own initializers give the JAX tree's leaves and shapes; a tree
    of another model raises."""
    params = variables["params"]
    back = dual_torch_to_flax(dual_flax_to_torch(params, port_model), heads=2)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, params))
    fresh = dual_torch_to_flax(pde.DualEncoderAU_LMK(**KW, aux_heads=True).state_dict(), 2)
    assert (jax.tree_util.tree_map(np.shape, fresh)
            == jax.tree_util.tree_map(np.shape, params))
    no_aux = pde.DualEncoderAU_LMK(**KW)
    with pytest.raises(ValueError, match="extra"):
        dual_flax_to_torch(params, no_aux)
    with pytest.raises(ValueError, match="need_aux"):
        no_aux(z_override=torch.zeros(2, 64), need_aux=True)


def test_initializers_follow_flax():
    """Kernels: flax's truncated LeCun normal (|w| ≤ 2 std, std ≈
    sqrt(1/fan_in)); biases 0; LayerNorm scales 1; the pooling query ~N(0, 1);
    a seed gives the same weights, another seed others."""
    m = pde.DualEncoderAU_LMK(au_dim=36, lmk_dim=132, d_model=256, depth=1, heads=4, seed=3)
    m.requires_grad_(False)
    w = m.au_enc.layer0.linear1.weight                # fan_in 256
    std = (1 / 256) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 0.02 * (1 / 256) ** 0.5
    assert float(m.au_enc.temporal1.weight.abs().max()) <= 2 * (1 / 3) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(m.au_enc.layer0.norm1.weight, torch.ones(256))
    assert float(m.head_fc1.bias.abs().max()) == 0.0
    assert abs(float(m.au_enc.pool.v.std()) - 1.0) < 0.15
    again = pde.DualEncoderAU_LMK(au_dim=36, lmk_dim=132, d_model=256, depth=1, heads=4, seed=3)
    other = pde.DualEncoderAU_LMK(au_dim=36, lmk_dim=132, d_model=256, depth=1, heads=4, seed=4)
    assert torch.equal(again.au_enc.proj.weight, m.au_enc.proj.weight)
    assert not torch.equal(other.au_enc.proj.weight, m.au_enc.proj.weight)


def test_masks_and_position_codes_match_jax():
    for lengths in (np.array([3, 1, 0, 4]), np.array([[1, 1, 0, 0], [0, 0, 0, 0],
                                                       [1, 0, 1, 0], [0, 1, 1, 1]])):
        got = pde.lengths_to_mask(torch.from_numpy(lengths), 4).numpy()
        assert np.array_equal(got, np.asarray(jde.lengths_to_mask(jnp.asarray(lengths), 4)))
    # sin and cos of float32 arguments: XLA's and torch's differ by an ulp
    assert max_rel_err(pde.sinusoidal_pe(8, 32).numpy(), jde.sinusoidal_pe(8, 32)) <= 1e-6


def test_grad_reverse_negates_and_scales_the_gradient():
    x = torch.tensor([0.5, -1.0, 2.0], requires_grad=True)
    y = pde.grad_reverse(x, 0.25)
    assert torch.equal(y, x)
    (y ** 2).sum().backward()
    assert torch.allclose(x.grad, -0.25 * 2 * x.detach())
    want = jax.grad(lambda v: jnp.sum(jde.grad_reverse(v, 0.25) ** 2))(jnp.asarray(x.detach()))
    assert np.allclose(x.grad.numpy(), np.asarray(want))


def test_dropout_keeps_and_scales_like_flax():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 50)
    y = pde.dropout(x, 0.2, True, g)
    kept = y != 0
    assert 0.75 < float(kept.float().mean()) < 0.85
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert pde.dropout(x, 0.2, False, None) is x and pde.dropout(x, 0.0, True, None) is x
    # the attention mask is one [T, T] draw shared by the batch and the heads
    w = pde.dropout(torch.ones(4, 2, 6, 6), 0.5, True, g, shape=(1, 1, 6, 6))
    assert torch.equal(w[0, 0] == 0, w[3, 1] == 0)
    with pytest.raises(ValueError):
        pde.dropout(x, 0.2, True, None)


# -- the dual losses --------------------------------------------------------------

def _loss_cases():
    rng = np.random.RandomState(5)
    logits = rng.randn(16).astype(np.float32) * 3
    y = (rng.rand(16) > 0.5).astype(np.float32)
    emb = rng.randn(16, 6).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q, k = rng.randn(4, 5, 3).astype(np.float32), rng.randn(4, 5, 3).astype(np.float32)
    pad = np.zeros((4, 5), bool)
    pad[1, 3:] = pad[2, 1:] = True
    keep = ~pad
    groups = np.array([0, 0, 1, 2, 2, 2, 3, 3, 1, 0, 4, 4, 4, 5, 5, 6])
    x = -np.abs(rng.randn(16)).astype(np.float32) * np.logspace(-6, 1, 16, dtype=np.float32)
    labels = y.astype(np.int32)
    return [
        ("focal_g2", lambda m, a: m.binary_focal_loss(a[0], a[1]), (logits, y)),
        ("focal_g1_a045", lambda m, a: m.binary_focal_loss(a[0], a[1], 1.0, 0.45), (logits, y)),
        ("focal_none_sum", lambda m, a: m.binary_focal_loss(a[0][:, None], a[1], 2.0, None, "sum"),
         (logits, y)),
        ("alignment", lambda m, a: m.alignment(a[0], a[1]), (emb, labels)),
        ("alignment_alpha1", lambda m, a: m.alignment(a[0], a[1], 1.0), (emb, labels)),
        ("uniformity", lambda m, a: m.uniformity(a[0], t=2.0), (emb,)),
        ("mse_masked", lambda m, a: m.mse_masked(a[0], a[1], a[2]), (q, k, keep)),
        ("mse_unmasked", lambda m, a: m.mse_masked(a[0], a[1], None), (q, k)),
        ("infonce_masked", lambda m, a: m.temporal_infonce(a[0], a[1], a[2], 0.1), (q, k, pad)),
        ("infonce", lambda m, a: m.temporal_infonce(a[0], a[1], None, 0.5), (q, k)),
        ("log1mexp", lambda m, a: m.log1mexp(a[0]).sum(), (x,)),
        ("noisy_or", lambda m, a: (m.noisy_or_group_logits(a[0], a[1], 16)[:7] ** 2).sum(),
         (logits, groups)),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _loss_cases()])
def test_loss_and_its_gradient_match_jax(case):
    """Each dual loss and its gradient in its first argument against JAX's,
    float32, within 1e-6 · max(1, max |JAX|)."""
    _, fn, args = next(c for c in _loss_cases() if c[0] == case)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs[0].requires_grad_(True)
    want, jgrad = jax.value_and_grad(lambda a0: fn(jl, [a0] + jargs[1:]))(jargs[0])
    got = fn(pl, targs)
    got.backward()
    assert max_rel_err(got.detach().numpy(), want) <= LOSS_TOL
    assert max_rel_err(targs[0].grad.numpy(), jgrad) <= LOSS_TOL
