"""K2's plain version, its wrapper and BN fold, and the fused ResBlock,
against the JAX package.

Inputs are numpy arrays from a seed, handed to both packages. The JAX side
runs the Pallas kernel as its own tests run it on the CPU
(``interpret=True``) and its conv3d oracle ``bottleneck_reference``. The
cases are those of ``tests/test_bottleneck_pallas.py`` plus a T and H that
the JAX tiles do not divide (against the oracle only: the Pallas wrapper
asserts divisibility). Tolerance in float32: 2e-4 abs and rel, as the JAX
test holds its own kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.ops.bottleneck_pallas import bottleneck_reference
from stdd_tpu.ops.bottleneck_pallas import fold_bn as jax_fold_bn
from stdd_tpu.ops.bottleneck_pallas import fused_bottleneck as jax_fused_bottleneck
from stdd_torch.models.i3d import ResBlock
from stdd_torch.ops.bottleneck import fold_bn, fused_bottleneck, fused_bottleneck_reference

TOL = 2e-4
NAMES = ("wa", "ba", "wb", "bb", "wc", "bc", "ws", "bs")


def _params(rng, tk, cin, ci, co, project):
    p = dict(wa=rng.randn(tk, cin, ci), ba=rng.randn(ci), wb=rng.randn(3, 3, ci, ci),
             bb=rng.randn(ci), wc=rng.randn(ci, co), bc=rng.randn(co))
    if project:
        p.update(ws=rng.randn(cin, co), bs=rng.randn(co))
    return {k: (v * 0.1).astype(np.float32) for k, v in p.items()}


def _torch_k2(x, p, tk, dtype=torch.float32):
    """The port's wrapper on a [B,T,H,W,C] numpy input (handed over as the
    channels_last_3d NCTHW view) → [B,T,H,W,Co] float32 numpy."""
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(dtype)
    ops = [torch.from_numpy(p[k]) if k in p else None for k in NAMES]
    y = fused_bottleneck(xt, *ops, tk=tk)
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last_3d)
    return y.float().permute(0, 2, 3, 4, 1).numpy()


def _jax_kernel(x, p, tk, tile_t, tile_h, out_dtype=jnp.float32):
    return np.asarray(jax_fused_bottleneck(
        jnp.asarray(x), *[p.get(k) for k in NAMES], tk=tk, tile_t=tile_t, tile_h=tile_h,
        interpret=True, out_dtype=out_dtype).astype(jnp.float32))


def _jax_oracle(x, p, tk):
    return np.asarray(bottleneck_reference(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()},
                                           tk=tk))


@pytest.mark.parametrize("tk,project,T,H,tile_t,tile_h", [
    (3, False, 8, 14, 8, 14),      # single tile
    (3, False, 16, 28, 8, 14),     # multi-tile: T and H halos + corners
    (3, True, 16, 28, 8, 14),      # projection shortcut
    (1, False, 8, 28, 4, 14),      # no temporal taps
])
def test_plain_k2_matches_jax_kernel_and_oracle(tk, project, T, H, tile_t, tile_h):
    rng = np.random.RandomState(0)
    B, W, cin, ci = 2, 10, 16, 8
    co = 24 if project else cin
    x = rng.randn(B, T, H, W, cin).astype(np.float32)
    p = _params(rng, tk, cin, ci, co, project)
    got = _torch_k2(x, p, tk)
    np.testing.assert_allclose(got, _jax_kernel(x, p, tk, tile_t, tile_h), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _jax_oracle(x, p, tk), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tk,project", [(3, True), (3, False), (1, True)])
def test_plain_k2_ragged_shape_matches_oracle(tk, project):
    """T = 5, H = 15, W = 9: no tiling of the JAX kernel fits, the port
    needs none (the CUDA kernel masks its ragged edge)."""
    rng = np.random.RandomState(1)
    cin, ci = 16, 8
    co = 32 if project else cin
    x = rng.randn(2, 5, 15, 9, cin).astype(np.float32)
    p = _params(rng, tk, cin, ci, co, project)
    np.testing.assert_allclose(_torch_k2(x, p, tk), _jax_oracle(x, p, tk), atol=TOL, rtol=TOL)


def test_plain_k2_bf16_matches_jax_kernel():
    """bf16 operands and intermediates, float32 sums: the port's plain
    version and the JAX kernel in interpret mode round at the same points.
    Tolerance: two bf16 ulps of max |ref| (a float32 sum that lands on the
    other side of a rounding boundary moves xa, xb or y by one ulp).
    Observed: 0.0 — the two agree bit for bit on this input."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 8, 28, 10, 16).astype(np.float32)
    p = _params(rng, 3, 16, 8, 24, True)
    want = _jax_kernel(x, p, 3, 8, 14, out_dtype=jnp.bfloat16)
    got = _torch_k2(x, p, 3, dtype=torch.bfloat16)
    tol = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= tol
    assert (got != want).mean() <= 0.01


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(3, 8, 4).astype(np.float32)
    scale = (rng.rand(4) + 0.5).astype(np.float32)
    bias, mean = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    var = (rng.rand(4) + 0.1).astype(np.float32)
    wj, bj = jax_fold_bn(*(jnp.asarray(a) for a in (w, scale, bias, mean, var)), 1e-5)
    wt, bt = fold_bn(*(torch.from_numpy(a) for a in (w, scale, bias, mean, var)), 1e-5)
    assert wt.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6, atol=1e-7)


def _case(project=False, cin=16, co=16):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 4, 6, 6, cin).astype(np.float32)).permute(0, 4, 1, 2, 3)
    p = _params(rng, 3, cin, 8, co, project)
    return x, [torch.from_numpy(p[k]) if k in p else None for k in NAMES]


@pytest.mark.parametrize("how", ["identity_width", "dtype", "tk", "ws_without_bs", "wb_shape"])
def test_wrapper_refuses_what_k2_does_not_take(how):
    x, ops = _case()
    kw = dict(tk=3)
    if how == "identity_width":
        x, ops = _case(cin=16, co=24)
        ops[6] = ops[7] = None
    elif how == "dtype":
        x = x.half()
    elif how == "tk":
        kw["tk"] = 5
    elif how == "ws_without_bs":
        ops[6] = torch.zeros(16, 16)
    elif how == "wb_shape":
        ops[2] = ops[2][:2]
    with pytest.raises(ValueError):
        fused_bottleneck(x, *ops, **kw)


def test_cpu_tensors_take_the_plain_version():
    x, ops = _case()
    before = fused_bottleneck.launches
    y = fused_bottleneck(x, *ops, tk=3)
    assert fused_bottleneck.launches == before
    torch.testing.assert_close(y, fused_bottleneck_reference(x, *ops, tk=3), rtol=0, atol=0)


def _jax_resblock_variables(rng, cin, co, ci, tk):
    """A JAX ResBlock's variables with non-trivial BN (as numpy)."""
    from stdd_tpu.models.i3d import ResBlock as JaxResBlock

    kw = dict(dim_in=cin, dim_out=co, dim_inner=ci, temp_kernel_size=tk, stride=1,
              zero_init_final_bn=False, bn_eps=1e-5, bn_momentum=0.1, axis_name=None,
              dtype=jnp.float32)
    x = jnp.zeros((1, 4, 6, 6, cin), jnp.float32)
    v = JaxResBlock(**kw).init(jax.random.PRNGKey(0), x, train=False)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.rand(*a.shape).astype(np.float32), v)
    return kw, v


@pytest.mark.parametrize("cin,co,tk", [(16, 16, 3), (16, 32, 3), (16, 16, 1)],
                         ids=["identity", "projection", "tk1"])
def test_fused_resblock_matches_jax_fused_resblock(cin, co, tk):
    """The port's ResBlock with ``fused_eval`` (BN folded once, K2's plain
    version on the CPU) against the JAX ResBlock with ``fused_eval`` and
    against its unfused path, on the same variables through the weight
    bridge's name map."""
    from stdd_tpu.models.i3d import ResBlock as JaxResBlock
    from stdd_torch.utils.weights import i3d_flax_to_torch

    rng = np.random.RandomState(5)
    kw, v = _jax_resblock_variables(rng, cin, co, 8, tk)
    x = rng.randn(2, 4, 6, 6, cin).astype(np.float32)
    want = np.asarray(JaxResBlock(fused_eval=True, **kw).apply(v, jnp.asarray(x), train=False))
    block = ResBlock(cin, co, 8, tk, 1, False, 1e-5, fused_eval=True)
    sd = i3d_flax_to_torch({"params": {"blk": v["params"]}, "batch_stats": {"blk": v["batch_stats"]}})
    block.load_state_dict({k[len("blk."):]: t for k, t in sd.items()})
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        unfused = ResBlock(cin, co, 8, tk, 1, False, 1e-5)
        unfused.load_state_dict(block.state_dict())
        plain = unfused.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=5e-4, rtol=5e-4)


def test_folded_weights_follow_every_weight_load():
    """BN is folded once per weight load: a second forward reuses the fold,
    and a ``load_state_dict`` after a forward takes effect."""
    rng = np.random.RandomState(6)
    block = ResBlock(16, 16, 8, 3, 1, False, 1e-5, fused_eval=True).eval()
    x = torch.from_numpy(rng.randn(1, 4, 6, 6, 16).astype(np.float32)).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        y0 = block(x)
        fold = block.folded_weights(torch.float32)
        assert block(x).equal(y0) and block.folded_weights(torch.float32) is fold
        sd = block.state_dict()
        sd["branch2.c.bn.weight"] = sd["branch2.c.bn.weight"] + 1.0
        sd["branch2.a.bn.running_mean"] = sd["branch2.a.bn.running_mean"] - 0.5
        block.load_state_dict(sd)
        y1 = block(x)
        assert block.folded_weights(torch.float32) is not fold
        unfused = ResBlock(16, 16, 8, 3, 1, False, 1e-5)
        unfused.load_state_dict(sd)
        torch.testing.assert_close(y1, unfused.eval()(x), atol=5e-4, rtol=5e-4)
    assert not y1.equal(y0)
