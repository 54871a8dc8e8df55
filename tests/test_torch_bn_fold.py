"""Eval BatchNorm folded into its convolution (``models/i3d.py::Conv3dBN``),
with BN's shift, the residual and the ReLU as one K3 pass
(``ops/bias_act.py``), on the CPU.

The fold runs on the card in 16 bits only (``Conv3dBN.folds``); here the
gate is widened to every eval forward, so the folded forward runs through
K3's plain version (``bias_act_reference``), and each place it changes is
held in float64 within 1e-10 to today's unfused eval forward: the I3D stem,
a block with a projection shortcut and one with the identity, the FTCN-TT
stem with its stride pool, and an FTCN-TT block whose ``b`` and shortcut
pool. The plain version itself equals the operations it replaces, and on
the CPU, in training and in int8, ``Conv3dBN`` folds nothing; the
benchmark's reader of K3's device time reads only its kernels. The card's
side is in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.lib.registry import metric_readers
from portbench.lib.trace import Trace
from stdd_torch.models.ftcn import FTCNBlock, TemporalConvBN
from stdd_torch.models.i3d import Conv3dBN, ResBlock, VideoStem, max_pool_3d
from stdd_torch.ops.bias_act import bias_act, bias_act_reference

CL = torch.channels_last_3d


def _randomize(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """float64, eval, every convolution and BN drawn (BN scales of both
    signs, so a max pool after BN is not a max pool of the raw output)."""
    g = torch.Generator().manual_seed(seed)
    model = model.double().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv3dBN):
                w = m.conv.weight
                w.copy_(torch.randn(w.shape, generator=g, dtype=w.dtype) / w[0].numel() ** 0.5)
                bn, C = m.bn, m.bn.num_features
                bn.weight.copy_(torch.randn(C, generator=g, dtype=w.dtype))
                bn.bias.copy_(0.3 * torch.randn(C, generator=g, dtype=w.dtype))
                bn.running_mean.copy_(0.3 * torch.randn(C, generator=g, dtype=w.dtype))
                bn.running_var.copy_(0.5 + torch.rand(C, generator=g, dtype=w.dtype))
    return model


# name: (module, forward(module, x), input [C, T, H, W], convolutions folded, K3 passes)
PLACES = {
    "i3d_stem": (lambda: VideoStem(3, 8, 3, 1e-5), lambda m, x: m(x), (3, 4, 16, 16), 1, 1),
    "block_projection": (lambda: ResBlock(8, 16, 8, 3, 2, False, 1e-5),
                         lambda m, x: m(x), (8, 4, 8, 8), 4, 3),
    "block_identity": (lambda: ResBlock(16, 16, 8, 1, 1, False, 1e-5),
                       lambda m, x: m(x), (16, 4, 6, 6), 3, 3),
    "ftcn_stem": (lambda: TemporalConvBN(3, 8, 5, True),
                  lambda m, x: max_pool_3d(m(x, relu=True), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
                  (3, 6, 16, 16), 1, 1),
    "ftcn_block_pooled": (lambda: FTCNBlock(8, 16, 8, 3, 2, 1e-5, 0.1),
                          lambda m, x: m(x), (8, 4, 8, 8), 4, 3),
}


@pytest.mark.parametrize("place", list(PLACES), ids=list(PLACES))
def test_folded_forward_equals_the_unfused_one(monkeypatch, place):
    build, fwd, shape, n_folded, n_passes = PLACES[place]
    model = _randomize(build(), 0)
    x = torch.randn((2,) + shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64).contiguous(memory_format=CL)
    with torch.no_grad():
        n0 = Conv3dBN.folded_convs
        want = fwd(model, x)
        assert Conv3dBN.folded_convs == n0                   # the CPU does not fold
        calls = []

        def reference(*args, **kw):
            calls.append(1)
            return bias_act_reference(*args, **kw)

        monkeypatch.setattr(Conv3dBN, "folds", lambda self, x, train: not train and not self.int8)
        monkeypatch.setattr("stdd_torch.ops.bias_act.bias_act_reference", reference)
        got = fwd(model, x)
    assert Conv3dBN.folded_convs - n0 == n_folded and len(calls) == n_passes
    assert got.dtype == torch.float64 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    assert float(want.abs().max()) > 0.1


@pytest.mark.parametrize("relu", [False, True], ids=["identity", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["no_residual", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16],
                         ids=["f32", "f64", "bf16"])
def test_plain_version_equals_the_operations_it_replaces(dtype, residual, relu):
    """``y + b`` (then ``+ r``, then ReLU) in float32, or float64, rounded
    once: for float32 and float64 exactly PyTorch's own operations in that
    order; for bf16 those operations over the widened operands."""
    g = torch.Generator().manual_seed(2)
    y = torch.randn(2, 16, 3, 4, 5, generator=g).to(dtype).contiguous(memory_format=CL)
    b = torch.randn(16, generator=g)
    r = torch.randn(y.shape, generator=g).to(dtype) if residual else None
    wide = torch.promote_types(dtype, torch.float32)
    want = y.to(wide) + b.to(wide).view(1, -1, 1, 1, 1)
    if residual:
        want = want + r.to(wide)
    want = (F.relu(want) if relu else want).to(dtype)
    y0 = y.clone()
    got = bias_act(y, b, r, relu)
    assert got is y and got.is_contiguous(memory_format=CL)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(y, y0)                               # in place


def test_wrapper_refuses_mismatched_operands():
    y = torch.zeros(2, 8, 3, 4, 4)
    with pytest.raises(ValueError):
        bias_act(y, torch.zeros(7))                             # bias not [C]
    with pytest.raises(ValueError):
        bias_act(y, torch.zeros(8), torch.zeros(2, 8, 3, 4, 5))  # residual's shape
    with pytest.raises(ValueError):
        bias_act(y, torch.zeros(8), y.double())                 # residual's dtype
    with pytest.raises(ValueError):
        bias_act(torch.zeros(8), torch.zeros(8))                # no channel axis


@pytest.mark.parametrize("mode", ["cpu_eval", "cpu_bf16_eval", "train", "int8"])
def test_conv3dbn_folds_nothing_off_the_card(mode):
    m = Conv3dBN(8, 16, (3, 1, 1), int8=mode == "int8")
    m.train(mode == "train")
    x = torch.randn(2, 8, 4, 6, 6, generator=torch.Generator().manual_seed(3))
    if mode == "cpu_bf16_eval":
        x = x.bfloat16()
    x = x.contiguous(memory_format=CL)
    n0, k0 = Conv3dBN.folded_convs, bias_act.launches
    with torch.set_grad_enabled(mode == "train"):
        y = m(x, train=mode == "train", relu=True)
    assert (Conv3dBN.folded_convs, bias_act.launches) == (n0, k0)
    assert y.dtype == x.dtype and float(y.detach().min()) >= 0
    assert m._fold is None


def test_fold_is_made_once_per_weight_load(monkeypatch):
    """The folded weight and shift are cached on the module and remade only
    when a source tensor is written (here ``load_state_dict``)."""
    monkeypatch.setattr(Conv3dBN, "folds", lambda self, x, train: not train and not self.int8)
    m = _randomize(Conv3dBN(8, 8, (1, 1, 1)), 4)
    x = torch.randn(1, 8, 2, 3, 3, dtype=torch.float64).contiguous(memory_format=CL)
    with torch.no_grad():
        m(x)
        first = m._fold
        m(x)
        assert m._fold is first
        sd = {k: v.clone() for k, v in m.state_dict().items()}
        sd["bn.bias"] += 1.0
        m.load_state_dict(sd)
        m(x)
    assert m._fold is not first
    torch.testing.assert_close(m._fold[1], first[1] + 1.0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fused", [False, True])
def test_a_module_made_under_inference_mode_folds_afresh(monkeypatch, fused):
    """Parameters made under ``torch.inference_mode`` keep no version
    counter, so nothing is cached: every forward folds again, through
    ``Conv3dBN`` alone and K2's ``ResBlock``, and gives what the same
    module made outside inference mode gives."""
    monkeypatch.setattr(Conv3dBN, "folds", lambda self, x, train: not train and not self.int8)

    def make():
        if fused:
            return ResBlock(16, 16, 8, 3, 1, False, 1e-5, fused_eval=True).eval()
        return Conv3dBN(16, 8, (3, 1, 1))

    dt = torch.float32 if fused else torch.float64              # K2 takes no float64
    x = torch.randn(1, 16, 3, 4, 4, dtype=dt).contiguous(memory_format=CL)
    ref = _randomize(make(), 5).to(dt)
    with torch.no_grad():
        want = ref(x)
    with torch.inference_mode():
        m = _randomize(make(), 5).to(dt)
        y0 = m(x)
        first = m._fold
        y1 = m(x)
        assert m._fold is not first
    assert y0.equal(want) and y1.equal(want)


def test_bias_act_ms_reader():
    """``scorer.bias_act_ms.dense``: the device ms of the kernels named
    ``bias_act`` over the windows scored; nothing on a program without K3."""
    reader = metric_readers()["scorer.bias_act_ms.dense"]
    assert reader.UNIT == "ms"
    names = ["void (anonymous namespace)::bias_act_kernel<__nv_bfloat16, true, true>(...)",
             "sm90_xmma_fprop_implicit_gemm_bf16bf16", "bias_act_kernel<__half, false, false>"]
    start = np.asarray([0, 2_000_000, 5_000_000], np.int64)
    end = np.asarray([1_000_000, 4_000_000, 5_500_000], np.int64)

    def rec(n, kind="dense", clips=3):
        empty = np.zeros(0, np.int64)
        tr = Trace(names[:n], start[:n], end[:n], np.zeros(n, np.int64), [], empty, empty, 1.0)
        return {"kind": kind, "trace": tr, "clips": clips}

    assert reader.read(rec(3)) == pytest.approx(1000.0 * 1.5e-3 / 3)
    assert reader.read(rec(2)) == pytest.approx(1000.0 * 1e-3 / 3)
    assert reader.read(rec(3, kind="live")) is None
    assert reader.read(rec(3, clips=0)) is None
    assert reader.read({"kind": "dense", "trace": None, "clips": 3}) is None
    # the parent's program has no such kernel: nothing to read
    t = rec(3)["trace"]
    t.dev_names = ["sm90_xmma_fprop"] * 3
    assert reader.read({"kind": "dense", "trace": t, "clips": 3}) is None
