"""The port on an NVIDIA card: K1 and K2 against their plain versions, the
scorer (unfused and ``fused_s2``, packed and dense) on the card against the
same scorer on the CPU, and the device-resident ring path (pushes and
gathers on a side CUDA stream) against the host-packed path.

Every test here needs a card: each is marked ``cuda`` and skips with the
reason "no CUDA device" where there is none. The file imports no JAX, so on
the machine with the card it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q -p no:cacheprovider

(``--noconftest``: the suite's conftest configures JAX). TF32 is off in
these tests, so float32 convolutions on the card compute in float32.
"""

import numpy as np
import pytest
import torch

from stdd_torch.config import I3DConfig, PipelineConfig
from stdd_torch.eval.scene import Scene
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.ops.bottleneck import KERNELS, fused_bottleneck, fused_bottleneck_reference
from stdd_torch.ops.warp import warp_affine, warp_affine_reference
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.runtime.engine import StreamingEngine

pytestmark = pytest.mark.cuda

CFG = I3DConfig(num_frames=8, crop_size=64)
PIPE = PipelineConfig(clip_size=8, imsize=64, stride=4, detect_every=2, batch_clips=2,
                      min_face_side=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_warp_kernel_matches_plain_version(cuda):
    """Bit-for-bit by design (same rounding order); 1e-3 allows for a
    compiler that reorders float32 arithmetic."""
    rng = np.random.RandomState(0)
    crops = torch.from_numpy(rng.randint(0, 256, (6, 50, 64, 3), np.uint8)).to(cuda)
    params = np.zeros((6, 8), np.float32)
    params[:, 0] = params[:, 4] = 0.8
    params[:, 1], params[:, 3] = 0.3, -0.3
    params[:, 2] = params[:, 5] = 4.0
    params[3, 2] = 40.0                                 # partly out of the crop
    params[4, 2] = np.nan                               # a padded slot
    params[5, 4] = np.inf
    p = torch.from_numpy(params).to(cuda)
    before = warp_affine.launches
    for c in (crops, crops.float()):
        got = warp_affine(c, p, 48)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert float((got - warp_affine_reference(c, p, 48)).abs().max()) <= 1e-3
        assert float(got[4:].abs().max()) == 0.0
    assert warp_affine.launches == before + 2


@pytest.mark.parametrize("N,S", [(1, 224), (3, 222), (2, 45)],
                         ids=["N1", "S222", "odd_S45"])
def test_warp_kernel_bit_exact_at_ragged_sizes(cuda, N, S):
    """One frame; S = 222, not a multiple of 4, whose 128-pixel strips cross
    rows; odd S, whose frames are not 16-byte aligned (scalar stores). Bit
    for bit with the plain version in uint8 and float32."""
    rng = np.random.RandomState(3)
    crops = torch.from_numpy(rng.randint(0, 256, (N, 250, 256, 3), np.uint8)).to(cuda)
    ang = np.radians(rng.uniform(-30, 30, N))
    c, s = np.cos(ang) * 1.1, np.sin(ang) * 1.1
    params = np.zeros((N, 8), np.float32)
    params[:, 0], params[:, 1], params[:, 3], params[:, 4] = c, -s, s, c
    params[:, 2] = 128 - (c - s) * S / 2
    params[:, 5] = 125 - (s + c) * S / 2
    p = torch.from_numpy(params).to(cuda)
    for crop in (crops, crops.float()):
        got = warp_affine(crop, p, S)
        torch.cuda.synchronize()
        assert got.shape == (N, S, S, 3)
        assert float((got - warp_affine_reference(crop, p, S)).abs().max()) == 0.0


def test_warp_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    crops = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    params = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError):
        warp_affine(crops.transpose(1, 2), params, 8)    # not contiguous
    with pytest.raises(ValueError):
        warp_affine(crops, params.cpu(), 8)              # two devices


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_scorer_on_card_matches_cpu(cuda, fmt):
    gpu = ClipScorer.random_init(CFG, seed=0, dtype=torch.float32, upload_format=fmt, device=cuda)
    cpu = ClipScorer(gpu.model.state_dict(), cfg=CFG, dtype=torch.float32, upload_format=fmt,
                     device="cpu")
    rng = np.random.RandomState(1)
    B, T, S = 2, 8, 96
    shape = (B, T, S * 3 // 2, S) if fmt == "yuv420" else (B, T, S, S, 3)
    crops = rng.randint(0, 256, shape, np.uint8)
    boxes = np.tile(np.array([100, 80, 100 + S, 80 + S], np.float32), (B, T, 1))
    lm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (B, T, 1, 1))
    lm5 = lm5 + rng.normal(0, 0.5, lm5.shape).astype(np.float32)
    valid = np.array([True, False])
    before = warp_affine.launches
    handle = gpu.score_async(crops, boxes, lm5, valid)
    got = np.asarray(handle)
    assert handle.is_ready()
    assert warp_affine.launches == before + 1
    want = cpu.score(crops, boxes, lm5, valid)
    assert got[1] == 0.0 and 0.0 < got[0] < 1.0
    assert np.abs(got - want).max() <= 1e-4


def _k2_operands(rng, B, T, H, W, cin, co, tk, project, dev, dtype):
    def w(*shape):
        fan = int(np.prod(shape[:-1]))
        return torch.from_numpy((rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)).to(dev)

    def b(n):
        return torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32)).to(dev)

    x = torch.from_numpy(rng.randn(B, T, H, W, cin).astype(np.float32)).to(dev)
    ops = [w(tk, cin, 64), b(64), w(3, 3, 64, 64), b(64), w(64, co), b(co)]
    ops += [w(cin, co), b(co)] if project else [None, None]
    return x.permute(0, 4, 1, 2, 3).to(dtype), ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,W,cin,co,tk,project", [
    (1, 4, 28, 28, 64, 256, 3, True),        # s2 block 0 widths, two tiles a side
    (2, 3, 16, 30, 256, 256, 3, False),      # blocks 1-2 widths, ragged tiles
    (1, 2, 9, 5, 64, 128, 1, True),          # tk = 1, smaller than one tile
], ids=["block0", "block1_ragged", "tk1"])
def test_k2_matches_plain_version(cuda, dtype, B, T, H, W, cin, co, tk, project):
    """Float32: within 1e-5 of max(1, max |ref|) (the sums run in another
    order). bf16: within two bf16 ulps of max |ref| on at most 1% of the
    elements (a float32 sum on the other side of a rounding boundary moves
    xa, xb or y by one ulp)."""
    x, ops = _k2_operands(np.random.RandomState(0), B, T, H, W, cin, co, tk, project, cuda, dtype)
    _check_k2(x, ops, tk)


def _check_k2(x, ops, tk):
    """K2 against its plain version: the kernel of x's dtype ran once."""
    dtype = x.dtype
    before = fused_bottleneck.launches
    by_kernel = dict(fused_bottleneck.launches_by_kernel)
    got = fused_bottleneck(x, *ops, tk=tk)
    want = fused_bottleneck_reference(x, *ops, tk=tk)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == before + 1
    assert {k: n - by_kernel[k] for k, n in fused_bottleneck.launches_by_kernel.items()} == {
        k: int(k == KERNELS[dtype]) for k in by_kernel}
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.isfinite(got).all()
    err = float((got.float() - want.float()).abs().max())
    ref = float(want.float().abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * max(1.0, ref)
    else:
        assert err <= 2 * 2.0 ** (np.floor(np.log2(ref)) - 7)
        assert float((got != want).float().mean()) <= 0.01


@pytest.mark.parametrize("cin,project", [(64, True), (256, False)], ids=["block0", "block1"])
def test_k2_bf16_at_the_dense_batch(cuda, cin, project):
    """bf16 (the tensor-core kernel) at score_dense's batch of 8 clips and
    the serving widths (T 32, H = W 56, Co 256), at _check_k2's tolerances."""
    x, ops = _k2_operands(np.random.RandomState(4), 8, 32, 56, 56, cin, 256, 3, project, cuda,
                          torch.bfloat16)
    _check_k2(x, ops, 3)


def test_k2_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.RandomState(1)
    x, ops = _k2_operands(rng, 1, 2, 8, 8, 256, 256, 3, False, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last_3d"):
        fused_bottleneck(x.contiguous(), *ops, tk=3)              # NCTHW memory
    with pytest.raises(ValueError, match="the kernel takes"):
        y, small = _k2_operands(rng, 1, 2, 8, 8, 16, 16, 3, False, cuda, torch.bfloat16)
        small[0], small[2], small[4] = small[0][..., :8], small[2][..., :8, :8], small[4][:8]
        small[1], small[3] = small[1][:8], small[3][:8]
        fused_bottleneck(y, *small, tk=3)                          # Ci = 8
    with pytest.raises(ValueError):
        fused_bottleneck(x, *[o.cpu() if o is not None else None for o in ops], tk=3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.empty(ops[0].numel() + 1, dtype=torch.bfloat16, device=cuda)[1:]
        misaligned = shifted.view(ops[0].shape).copy_(ops[0])       # 2 bytes past 16
        fused_bottleneck(x, misaligned, *ops[1:], tk=3)


def _dense_track(rng, n=14, S=96):
    frames = rng.randint(0, 256, (n, S, S, 3), np.uint8)
    boxes = np.tile(np.array([100, 80, 100 + S, 80 + S], np.float32), (n, 1))
    lm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (n, 1, 1))
    return frames, boxes, lm5 + rng.normal(0, 0.5, lm5.shape).astype(np.float32)


def test_fused_scorer_on_card_matches_cpu(cuda):
    """``fused_s2`` in float32: K2 on the card against its plain version on
    the CPU through the whole scorer, packed clips and dense windows; three
    K2 launches per I3D forward."""
    cfg = I3DConfig(num_frames=8, crop_size=64, fused_s2=True)
    gpu = ClipScorer.random_init(cfg, seed=0, dtype=torch.float32, device=cuda)
    cpu = ClipScorer(gpu.model.state_dict(), cfg=cfg, dtype=torch.float32, device="cpu")
    frames, boxes, lm5 = _dense_track(np.random.RandomState(2))
    starts = np.array([0, 3, 6])
    before = fused_bottleneck.launches
    got = gpu.score_dense(frames, boxes, lm5, starts, batch=2)
    assert fused_bottleneck.launches == before + 3 * 2          # two forwards
    assert np.abs(got - cpu.score_dense(frames, boxes, lm5, starts, batch=2)).max() <= 1e-4
    idx = starts[:, None] + np.arange(8)
    p, logits, feats = gpu.score_with_features(frames[idx], boxes[idx], lm5[idx], np.ones(3, bool))
    pc, lc, fc = cpu.score_with_features(frames[idx], boxes[idx], lm5[idx], np.ones(3, bool))
    assert np.abs(p - pc).max() <= 1e-4 and np.abs(feats - fc).max() <= 1e-4 * max(1, np.abs(fc).max())


def _engine_stream(scorer, device_resident):
    scene = Scene((240, 320), n_faces=2, seed=0, face_px=72)
    eng = StreamingEngine(scorer, scene.oracle(PIPE.detect_every), cfg=PIPE, crop_buffer=160,
                          q_weighting=False, q_lap_hard=0.0, start_conf=0.3,
                          device_resident=device_resident)
    try:
        out = []
        for i in range(36):
            out += eng.step(scene.frame(i))
        out += eng.flush()
    finally:
        eng.close()
    return out


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_ring_path_on_card_matches_packed_path(cuda, fmt):
    """Pushes and window gathers run on the ring's side stream and the
    scorer on the current one; the event fences keep every window equal to
    the host-packed clip of the same frames."""
    scorer = ClipScorer.random_init(CFG, seed=0, dtype=torch.float32, upload_format=fmt,
                                    device=cuda)
    before = warp_affine.launches
    ring = _engine_stream(scorer, True)
    packed = _engine_stream(scorer, False)
    assert warp_affine.launches > before
    assert len(ring) >= 10 and [t for t, _ in ring] == [t for t, _ in packed]
    assert np.abs(np.array([p for _, p in ring]) - np.array([p for _, p in packed])).max() <= 1e-5
