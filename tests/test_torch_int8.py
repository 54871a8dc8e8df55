"""The port's int8 serving knob (``models/i3d.py::int8_conv``,
``I3DConfig.int8_stages``, ``ClipScorer(int8=)``, ``--int8``) against the JAX
package's (``stdd_tpu/models/i3d.py::Conv3dBN._int8_conv``).

Inputs come from numpy seeds. The quantized integers must be bit-equal to
JAX's, the int32 accumulators bit-equal to the plain version (a float64
convolution of the integers, exact) and to an int64 numpy convolution, and
``Conv3dBN(int8=True)`` within 1e-5 (rtol and atol) of JAX's module. The
whole float32 I3D with ``int8_stages=("s3", "s4", "s5")`` stays within 1e-3
of JAX's probs; the test also counts the quantized activations that differ
between the packages (a float32 rounding difference on either side of a
half can move one integer by one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.models import i3d as jax_i3d
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_torch.config import I3DConfig
from stdd_torch.models import i3d
from stdd_torch.models.i3d import I3D, Conv3dBN
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.utils.weights import i3d_flax_to_torch

from torch_port_helpers import port_i3d_variables

CFG = dict(num_frames=4, crop_size=32, width_per_group=8)
STAGES = ("s3", "s4", "s5")
CONV_CASES = [((1, 1, 1), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)), ((3, 1, 1), (1, 1, 1))]


def np_int_conv(xq, wq, stride, pad):
    """int64 direct 3D convolution of integers ``xq`` [B, T, H, W, C] by
    ``wq`` [kt, kh, kw, C, F] (``tests/test_int8.py``'s ground truth)."""
    kt, kh, kw, _, F = wq.shape
    xp = np.pad(xq.astype(np.int64), [(0, 0)] + [(p, p) for p in pad] + [(0, 0)])
    st, sh, sw = stride
    To = (xp.shape[1] - kt) // st + 1
    Ho = (xp.shape[2] - kh) // sh + 1
    Wo = (xp.shape[3] - kw) // sw + 1
    out = np.zeros((xq.shape[0], To, Ho, Wo, F), np.int64)
    w64 = wq.astype(np.int64)
    for t in range(To):
        for i in range(Ho):
            for j in range(Wo):
                patch = xp[:, t * st:t * st + kt, i * sh:i * sh + kh, j * sw:j * sw + kw, :]
                out[:, t, i, j, :] = np.tensordot(patch, w64, axes=([1, 2, 3, 4], [0, 1, 2, 3]))
    return out


def jax_quantized(w, x):
    """JAX's integers and scales, by ``_int8_conv``'s own ops."""
    sw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2, 3)), 1e-8) / 127.0
    wq = jnp.round(w / sw).astype(jnp.int8)
    sx = jnp.maximum(jnp.max(jnp.abs(x)).astype(jnp.float32), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    return np.asarray(wq), np.asarray(xq), np.asarray(sw), float(sx)


def _bn_tree(rng, f):
    return ({"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
             "bias": rng.normal(0, 0.2, f).astype(np.float32)},
            {"mean": rng.normal(0, 0.2, f).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, f).astype(np.float32)})


@pytest.mark.parametrize("kernel,stride,dtype", [c + ("float32",) for c in CONV_CASES]
                         + [((1, 3, 3), (1, 2, 2), "bfloat16")],
                         ids=["1x1x1", "1x3x3s2", "3x1x1", "1x3x3s2-bf16"])
def test_conv3dbn_int8_matches_jax(kernel, stride, dtype):
    rng = np.random.RandomState(0)
    cin, cout = 12, 10                      # K and N not multiples of 8: the padded GEMM
    x = rng.randn(2, 4, 6, 6, cin).astype(np.float32)
    w = (rng.randn(*kernel, cin, cout) * 0.2).astype(np.float32)
    pad = tuple(k // 2 for k in kernel)
    bn_p, bn_s = _bn_tree(rng, cout)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x).astype(jdt)

    mod = jax_i3d.Conv3dBN(features=cout, kernel=kernel, stride=stride,
                           padding=[(p, p) for p in pad], int8=True, dtype=jdt)
    v = {"params": {"conv": {"kernel": jnp.asarray(w)}, "bn": bn_p}, "batch_stats": {"bn": bn_s}}
    want = np.asarray(mod.apply(v, xj, train=False).astype(jnp.float32))

    port = Conv3dBN(cin, cout, kernel, stride, pad, int8=True).eval()
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2)))
        port.bn.weight.copy_(torch.from_numpy(bn_p["scale"]))
        port.bn.bias.copy_(torch.from_numpy(bn_p["bias"]))
        port.bn.running_mean.copy_(torch.from_numpy(bn_s["mean"]))
        port.bn.running_var.copy_(torch.from_numpy(bn_s["var"]))
    xt = torch.from_numpy(x).to(tdt).permute(0, 4, 1, 2, 3)
    before = i3d.int8_conv_acc.launches
    with torch.inference_mode():
        got = port(xt)
    assert i3d.int8_conv_acc.launches == before + 1       # the integer GEMM ran
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 4, 1).numpy()

    # the integers, bit for bit, and the accumulators against two plain versions
    wq_j, xq_j, sw_j, sx_j = jax_quantized(jnp.asarray(w), xj)
    wq, sw = i3d.quantize_weight(port.conv.weight.detach())
    xq, sx = i3d.quantize_activation(xt)
    np.testing.assert_array_equal(wq.permute(2, 3, 4, 1, 0).numpy(), wq_j)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 4, 1).numpy(), xq_j)
    np.testing.assert_array_equal(sw.numpy(), sw_j)
    assert float(sx) == sx_j
    acc = i3d.int8_conv_acc(xq, wq, stride, pad)
    assert acc.dtype == torch.int32
    torch.testing.assert_close(acc, i3d.int8_conv_acc_reference(xq, wq, stride, pad),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 4, 1).numpy(),
                                  np_int_conv(xq_j, wq_j, stride, pad))
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,kernel,stride", [
    ((1, 16, 2, 5, 5), (1, 1, 1), (1, 2, 2)),       # s4's projection at this width, M < 17
    ((3, 24, 3, 7, 7), (3, 1, 1), (1, 1, 1)),
    ((2, 8, 2, 9, 9), (1, 3, 3), (1, 2, 2)),
    ((1, 64, 1, 4, 4), (1, 1, 1), (1, 1, 1)),
], ids=["proj-s2", "3x1x1", "1x3x3s2", "1x1x1"])
def test_int8_accumulators_equal_the_plain_version(shape, kernel, stride):
    rng = np.random.RandomState(1)
    xq = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    xq = xq.contiguous(memory_format=torch.channels_last_3d)
    wq = torch.from_numpy(rng.randint(-127, 128, (11, shape[1]) + kernel).astype(np.int8))
    pad = tuple(k // 2 for k in kernel)
    acc = i3d.int8_conv_acc(xq, wq, stride, pad)
    torch.testing.assert_close(acc, i3d.int8_conv_acc_reference(xq, wq, stride, pad),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def variables():
    return port_i3d_variables(I3DConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def clips():
    return np.random.RandomState(3).rand(2, 4, 32, 32, 3).astype(np.float32) * 2 - 1


def test_i3d_int8_stages_match_jax(variables, clips, monkeypatch):
    """float32, ``int8_stages=("s3", "s4", "s5")``: probs within 1e-3 of
    JAX's; at most one activation integer in 10⁴ differs (each by one)."""
    jx, px = [], []
    conv = jax.lax.conv_general_dilated

    def spy(lhs, *a, **k):
        if lhs.dtype == jnp.int8:
            jax.debug.callback(lambda v: jx.append(np.asarray(v)), lhs, ordered=True)
        return conv(lhs, *a, **k)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    jm = jax_i3d.I3D(cfg=JaxI3DConfig(**CFG, int8_stages=STAGES))
    lj = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(clips)))
    jax.effects_barrier()
    monkeypatch.undo()

    quant = i3d.quantize_activation

    def pspy(x):
        xq, sx = quant(x)
        px.append(xq.permute(0, 2, 3, 4, 1).numpy())
        return xq, sx

    monkeypatch.setattr(i3d, "quantize_activation", pspy)
    model = I3D(I3DConfig(**CFG, int8_stages=STAGES))
    model.load_state_dict(i3d_flax_to_torch(variables, model))
    with torch.inference_mode():
        lp = model.eval()(torch.from_numpy(clips)).numpy()
    n_convs = sum(m.int8 for m in model.modules() if isinstance(m, Conv3dBN))
    assert len(jx) == len(px) == n_convs == 3 * (4 + 6 + 3) + 3
    flipped = sum(int((a != b).sum()) for a, b in zip(px, jx))
    total = sum(a.size for a in jx)
    assert all(int(np.abs(a.astype(int) - b).max(initial=0)) <= 1 for a, b in zip(px, jx))
    assert flipped <= total * 1e-4, (flipped, total)
    pj, pp = 1 / (1 + np.exp(-lj)), 1 / (1 + np.exp(-lp))
    assert np.abs(pp - pj).max() <= 1e-3, np.abs(pp - pj).max()


def test_i3d_int8_wiring(variables, clips):
    """Same parameter tree as the float model; every conv of s3-s5 (the
    projections included) and none of s1/s2 takes the int8 path; eval
    probs within 0.05 of the float path's; train mode bit-equal to it."""
    f = I3D(I3DConfig(**CFG))
    q = I3D(I3DConfig(**CFG, int8_stages=STAGES))
    assert list(f.state_dict()) == list(q.state_dict())
    sd = i3d_flax_to_torch(variables, f)
    f.load_state_dict(sd)
    q.load_state_dict(sd)
    for name, m in q.named_modules():
        if isinstance(m, Conv3dBN):
            assert m.int8 == (name.split(".")[0] in STAGES), name
    x = torch.from_numpy(clips)
    with torch.inference_mode():
        pf = torch.sigmoid(f.eval()(x))
        pq = torch.sigmoid(q.eval()(x))
    assert torch.isfinite(pq).all() and (pq - pf).abs().max() < 0.05
    before = i3d.int8_conv_acc.launches
    outs = []
    for m in (f, q):
        m.train()
        with torch.no_grad():
            outs.append(m(x, train=True, generator=torch.Generator().manual_seed(1)))
    assert i3d.int8_conv_acc.launches == before
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    torch.testing.assert_close(f.state_dict(), q.state_dict(), rtol=0, atol=0)


def _score_inputs(B=2, T=4, S=48):
    rng = np.random.RandomState(0)
    crops = rng.randint(0, 255, (B, T, S, S, 3)).astype(np.uint8)
    boxes = np.tile(np.array([4.0, 4.0, 44.0, 44.0], np.float32), (B, T, 1))
    lm5 = np.tile((STD_POINTS_256 * (40 / 256.0) + 4).astype(np.float32), (B, T, 1, 1))
    return crops, boxes, lm5, np.ones(B, bool)


def test_clip_scorer_int8_knob_matches_jax(variables):
    """``int8=True`` sets s3-s5 when the config names no stages and leaves
    an explicit choice alone (``tests/test_int8.py:98-121``); its float32
    probs follow JAX's int8 scorer on the same clips within 1e-3."""
    cfg = I3DConfig(**CFG)
    s = ClipScorer.from_flax_variables(variables, cfg=cfg, dtype=torch.float32, device="cpu",
                                       int8=True)
    assert s.cfg.int8_stages == STAGES
    pre = ClipScorer.random_init(cfg=I3DConfig(**CFG, int8_stages=("s4",)), device="cpu",
                                 int8=True)
    assert pre.cfg.int8_stages == ("s4",)
    assert ClipScorer.random_init(cfg=cfg, device="cpu").cfg.int8_stages == ()
    js = JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32, int8=True)
    assert js.cfg.int8_stages == STAGES
    args = _score_inputs()
    got, want = s.score(*args), np.asarray(js.score(*args))
    assert np.abs(got - want).max() <= 1e-3, (got, want)


def test_scorer_int8_composes_with_fused_s2_temporal_only_and_i420(variables):
    """K2 (its plain version here) keeps s2 under ``fused_s2`` + int8 and
    gives the unfused int8 scorer's probs; a ``temporal_only`` trunk takes
    int8 on the stages it has; the I420 upload scores as RGB does."""
    from stdd_torch.runtime.packing import rgb_to_i420

    args = _score_inputs()
    base = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG),
                                          dtype=torch.float32, device="cpu", int8=True)
    fused = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG, fused_s2=True),
                                           dtype=torch.float32, device="cpu", int8=True)
    assert [b.fused_eval for b in fused.model.s2.children()] == [True] * 3
    np.testing.assert_allclose(fused.score(*args), base.score(*args), atol=1e-4)

    tcfg = I3DConfig(**CFG, temporal_only=True)
    t = ClipScorer.random_init(cfg=tcfg, dtype=torch.float32, device="cpu", int8=True)
    assert t.model.stage_names == ["s2", "s3", "s4"]
    assert [n.split(".")[0] for n, m in t.model.named_modules()
            if isinstance(m, Conv3dBN) and m.int8][::5][:2] == ["s3", "s3"]
    p = t.score(*args)
    assert np.isfinite(p).all() and ((p > 0) & (p < 1)).all()

    yuv = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                         device="cpu", int8=True, upload_format="yuv420")
    crops = args[0]
    planar = np.zeros(crops.shape[:2] + (48 * 3 // 2, 48), np.uint8)
    for b in range(crops.shape[0]):
        for t in range(crops.shape[1]):
            rgb_to_i420(crops[b, t], planar[b, t])
    py = yuv.score(planar, *args[1:])
    assert np.isfinite(py).all() and py.shape == (2,)


@pytest.mark.parametrize("cli", ["app", "harness", "demo"])
def test_each_cli_passes_int8_to_the_scorer(cli, monkeypatch, tmp_path):
    """``--int8`` reaches ``load_scorer(..., int8=True)`` in the app, the
    harness and the demo (each stops at the scorer here)."""
    from stdd_torch.eval import demo, harness
    from stdd_torch.runtime import app, classifier
    from stdd_torch.utils.video_io import write_y4m

    seen = {}

    class Stop(Exception):
        pass

    def fake_load(*a, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(classifier, "load_scorer", fake_load)
    video = str(tmp_path / "real" / "a.y4m")
    (tmp_path / "real").mkdir()
    write_y4m(video, [np.zeros((32, 32, 3), np.uint8)] * 2)
    argv = {"app": (app.main, ["--source", video]),
            "harness": (harness.main, ["--video_root", str(tmp_path)]),
            "demo": (demo.main, ["--video_root", str(tmp_path)])}[cli]
    with pytest.raises(Stop):
        argv[0](argv[1] + ["--int8", "--device", "cpu"])
    assert seen["int8"] is True
