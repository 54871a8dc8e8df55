"""The port on an NVIDIA card: K1 and K2 against their plain versions, the
scorer (unfused and ``fused_s2``, packed and dense, temporal-only) on the
card against the same scorer on the CPU, the device-resident ring path
(pushes and gathers on a side CUDA stream) against the host-packed path,
the reference-quantization mode (``round_aligned_u8``) through K1 and
``score_index``, the data production models, the evaluation harness's
``run_video`` and a reference-format checkpoint on the card against the
CPU, the FTCN's
forward and train step on the card against the CPU, the int8 convolutions
(the int32 GEMM on the card against its plain version, the int8 scorer
against the CPU's) and a data-parallel step on the card (world 1 over NCCL,
world 2 over gloo carrying CUDA tensors) against the single-process step,
the bf16 stem and temporal convolutions re-laid for the tensor cores, and K3
(BN's shift, the residual and ReLU in one pass) against its plain version
with the bf16 forwards that fold BN into the convolutions against the
unfused ones.

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
import torch.nn.functional as F

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


# -- the data-production plane: renderer, landmarker, AU ResNet-18 ----------------
# float32 with TF32 off on both devices; convolutions and transcendentals sum
# and round in another order on the card, so the bounds are 1e-4 (renders in
# [0, 1], the landmarker's crop-normalized outputs, AU activations in [0, 1])

def test_renderer_and_landmarker_on_card_match_cpu(cuda):
    from stdd_torch.models.facemesh import DenseLandmarker, render_faces, sample_params

    rigid, theta, style = sample_params(torch.Generator().manual_seed(0), 6)
    cpu_imgs = render_faces(rigid, theta, style)
    gpu_imgs = render_faces(rigid.to(cuda), theta.to(cuda), style.to(cuda))
    assert float((gpu_imgs.cpu() - cpu_imgs).abs().max()) <= 2.5e-4
    lm_gpu = DenseLandmarker.pretrained()
    assert lm_gpu.device.type == "cuda"
    lm_cpu = DenseLandmarker.pretrained(device="cpu")
    pg, tg = lm_gpu.forward(cpu_imgs.to(cuda))
    pc, tc = lm_cpu.forward(cpu_imgs)
    assert float((pg.cpu() - pc).abs().max()) <= 1e-4
    assert float((tg.cpu() - tc).abs().max()) <= 1e-4
    frame = (cpu_imgs[0].numpy() * 255).astype(np.uint8)
    assert np.abs(lm_gpu(frame, (10, 10, 110, 110)) - lm_cpu(frame, (10, 10, 110, 110))).max() <= 0.05


def test_au_resnet_on_card_matches_cpu(cuda):
    from stdd_torch.models.au_resnet import AUExtractor
    from stdd_torch.utils.weights import torch_to_flax

    cpu = AUExtractor.random_init(seed=0, device="cpu")
    gpu = AUExtractor(torch_to_flax(cpu.model.state_dict()))
    assert gpu.device.type == "cuda"
    faces = np.random.RandomState(0).randint(0, 256, (4, 240, 200, 3), np.uint8)
    assert np.abs(gpu.activations(faces) - cpu.activations(faces)).max() <= 1e-4


# -- the offline evaluation harness and the reference-checkpoint loader ---------


def _fixed_detector(frame_bgr):
    lm = (STD_POINTS_256 * (50 / 256.0) + np.array([30, 25])).reshape(-1)
    return np.asarray([[30, 25, 50.0, 55.0, *lm, 0.95]], np.float32)


def test_harness_run_video_on_card_matches_cpu(cuda, tmp_path):
    """``eval/harness.py::run_video`` over a ``.y4m`` on the card (device
    rings, K1) against the same engine on the CPU: the verdict equal, the
    video score within the scorer's float32 bound."""
    from stdd_torch.eval.harness import run_video
    from stdd_torch.utils.video_io import write_y4m

    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (120, 160, 3), np.uint8)
    path = str(tmp_path / "real" / "a.y4m")
    (tmp_path / "real").mkdir()
    write_y4m(path, [np.roll(base, i, axis=1) for i in range(24)])
    gpu = ClipScorer.random_init(CFG, seed=0, dtype=torch.float32, device=cuda)
    cpu = ClipScorer(gpu.model.state_dict(), cfg=CFG, dtype=torch.float32, device="cpu")
    pipe = PipelineConfig(clip_size=8, stride=4, detect_every=2, batch_clips=2, min_face_side=5)
    rows = {}
    before = warp_affine.launches
    for name, scorer in (("gpu", gpu), ("cpu", cpu)):
        eng = StreamingEngine(scorer, _fixed_detector, cfg=pipe, crop_buffer=128,
                              q_lap_hard=0.0, q_weighting=False)
        try:
            rows[name] = run_video(eng, path, threshold=0.5)
        finally:
            eng.close()
        if name == "gpu":
            assert eng.device_resident and warp_affine.launches > before
    g, c = rows["gpu"], rows["cpu"]
    assert g["frames_processed"] == c["frames_processed"] == 24
    assert g["num_tracks"] == c["num_tracks"] == 1
    assert g["pred_label"] == c["pred_label"]
    assert abs(g["video_score"] - c["video_score"]) <= 1e-4


def test_from_torch_checkpoint_on_card(cuda, tmp_path):
    """A reference-format ``.pth`` served on the card: the file's weights,
    and probs within the float32 bound of the same file on the CPU."""
    from stdd_torch.utils.torch_convert import i3d_torch_to_reference

    src = ClipScorer.random_init(CFG, seed=3, dtype=torch.float32, device="cpu")
    path = str(tmp_path / "ref.pth")
    torch.save({"classifier": i3d_torch_to_reference(src.model.state_dict())}, path)
    gpu = ClipScorer.from_torch_checkpoint(path, cfg=CFG, dtype=torch.float32, device=cuda)
    cpu = ClipScorer.from_torch_checkpoint(path, cfg=CFG, dtype=torch.float32, device="cpu")
    for k, v in src.model.state_dict().items():
        assert torch.equal(gpu.model.state_dict()[k].cpu(), v), k
    rng = np.random.RandomState(2)
    crops = rng.randint(0, 256, (2, 8, 96, 96, 3), np.uint8)
    boxes = np.tile(np.array([100, 80, 196, 176], np.float32), (2, 8, 1))
    lm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (2, 8, 1, 1))
    valid = np.array([True, True])
    got, want = gpu.score(crops, boxes, lm5, valid), cpu.score(crops, boxes, lm5, valid)
    assert np.all((got > 0) & (got < 1)) and np.abs(got - want).max() <= 1e-4


# -- the overlay, the annotator and multigrid (the drawing is host numpy) -------

def test_app_writes_the_overlay_on_the_card(cuda, tmp_path):
    """``run_loop(..., out_video=O.y4m, on_frame=...)`` with the scorer on
    the card (device rings, K1): every frame written, the file the
    in-memory overlays' ``.y4m`` round trip, the boxes drawn."""
    from stdd_torch.runtime.app import RealtimeApp, run_loop
    from stdd_torch.utils.video_io import read_y4m, write_y4m

    scene = Scene((240, 320), n_faces=1, seed=0, face_px=96)
    frames = [scene.frame(i) for i in range(20)]
    scorer = ClipScorer.random_init(CFG, seed=0, device=cuda)
    eng = StreamingEngine(scorer, scene.oracle(PIPE.detect_every), cfg=PIPE, crop_buffer=128,
                          q_lap_hard=0.0, q_weighting=False)
    overlays, path = [], str(tmp_path / "o.y4m")
    before = warp_affine.launches
    try:
        app = RealtimeApp(eng, threshold=0.0, decision_min_frames=8)
        run_loop(app, iter(frames), out_video=path, on_frame=overlays.append)
    finally:
        eng.close()
    assert eng.device_resident and warp_affine.launches > before
    assert len(overlays) == 20 and any((o != f).any() for o, f in zip(overlays, frames))
    ref = str(tmp_path / "want.y4m")
    write_y4m(ref, overlays)
    got, want = list(read_y4m(path)), list(read_y4m(ref))
    assert len(got) == len(want) == 20
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_viz_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The annotator's detector and landmarker on the card against the CPU
    (TF32 off): the same rows (≤ 1e-3 px, ≤ 1e-5 in score), the same
    tracks, landmarks within ``chip_smoke.LANDMARK_TOLS``' 1e-4 of the crop
    (≤ 0.05 px on these boxes), and the same drawn frames but for the
    landmarks' integer truncation."""
    from stdd_torch.config import DetectorConfig
    from stdd_torch.eval.viz import make_annotator
    from stdd_torch.models.facemesh import DenseLandmarker
    from stdd_torch.models.yunet import YuNet, detect_scaled
    from stdd_torch.track.byte_tracker import ByteTracker
    from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph

    det_model = write_onnx(yunet_shaped_graph(0), str(tmp_path / "y.onnx"))
    scene = Scene((240, 320), n_faces=2, seed=1, face_px=80)
    frames = [scene.frame(i) for i in range(4)]
    out, rows, pts = {}, {}, {}
    for name, dev in (("gpu", cuda), ("cpu", torch.device("cpu"))):
        det = YuNet(det_model, DetectorConfig(conf_threshold=0.6), device=dev)
        lm = DenseLandmarker.pretrained(device=dev)
        rows[name] = [detect_scaled(det, f, 64) for f in frames]
        tracker = ByteTracker(track_thresh=0.5, match_thresh=0.8, track_buffer=30,
                              split_low_scores=False)
        ann = make_annotator(lambda f: detect_scaled(det, f, 64), tracker)
        out[name] = [ann(f) for f in frames]
        pts[name] = [lm(frames[0][:, :, ::-1], (40, 30, 140, 150))]
    for g, c in zip(rows["gpu"], rows["cpu"]):
        assert g.shape == c.shape and g.size > 0
        assert np.abs(g[:, :14] - c[:, :14]).max() <= 1e-3
        assert np.abs(g[:, 14] - c[:, 14]).max() <= 1e-5
    assert np.abs(pts["gpu"][0] - pts["cpu"][0]).max() <= 0.05
    for g, c in zip(out["gpu"], out["cpu"]):
        np.testing.assert_array_equal(g, c)


def test_multigrid_shape_switch_on_the_card(cuda):
    """Two long-cycle shapes of a small I3D in bf16 on the card: the step
    runs at each, the loss stays finite, the state carries across."""
    from stdd_torch.train.engine_i3d import I3DTrainArgs
    from stdd_torch.train.measure_multigrid import Run, make_batch
    from stdd_torch.train.multigrid import MultigridConfig, MultigridSchedule

    mg = MultigridConfig(default_b=2, default_t=8, default_s=32, solver_steps=(0, 2, 3),
                         solver_max_epoch=4, epoch_factor=1.0)
    sched = MultigridSchedule(mg)
    run = Run(I3DConfig(num_frames=8, crop_size=32), torch.bfloat16,
              I3DTrainArgs(base_lr=0.02, max_epoch=4, steps_per_epoch=2), cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes, losses, prev = [], [], None
    for epoch in range(2):
        shape, changed = sched.update(epoch, prev)
        assert changed
        prev = shape
        bf, T, S = shape
        for _ in range(2):
            clips, y = make_batch(gen, bf * mg.default_b, T, S, cuda)
            run.state, m = run.step_fn(run.state, clips, y, 0)
            losses.append(float(m["loss"]))
        shapes.append(shape)
    assert shapes[0] != shapes[1] and run.state.step == 4
    assert np.isfinite(losses).all()


def test_ftcn_forward_and_step_on_the_card_match_the_cpu(cuda):
    """The FTCN (narrow, 8×64², float32, TF32 off): eval logits on the card
    against the CPU, then one AltFreezing step on each from the same
    weights and batch, dropout off: the loss and BN statistics within 1e-5
    (BN over max(1, |x|)), the gradients' norm within 1e-2 relative."""
    from stdd_torch.models.ftcn import FTCN
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training
    from stdd_torch.utils.weights import torch_to_flax

    cfg = I3DConfig(depth=18, width_per_group=8, num_frames=8, crop_size=64, temporal_only=True)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 64, 64, 3).astype(np.float32))
    y = torch.tensor([0.0, 1.0])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = FTCN(cfg).to(dev)
        state, step, _ = init_i3d_training(model, I3DTrainArgs(steps_per_epoch=2, max_epoch=1))
        model.head.dropout = 0.0
        with torch.no_grad():
            logits = model(x.to(dev)).cpu()
        state, m = step(state, x.to(dev), y.to(dev), 0)
        out[dev.type] = (logits, float(m["loss"]), float(m["grad_norm"]),
                         torch_to_flax(model.state_dict())["batch_stats"])
    g, c = out["cuda"], out["cpu"]
    assert (g[0] - c[0]).abs().max() <= 1e-4
    assert abs(g[1] - c[1]) <= 1e-5 and abs(g[2] / c[2] - 1) <= 1e-2
    for a, b in zip(_leaves(g[3]), _leaves(c[3])):
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_temporal_only_scorer_uses_k1_and_matches_the_plain_warp(cuda):
    """A temporal-only I3D scorer on the card: K1 launches once a batch and
    K2 never (its blocks are 1×1×1), and the probs equal those of the same
    scorer through K1's plain version and of the CPU scorer."""
    cfg = I3DConfig(num_frames=8, crop_size=64, temporal_only=True, fused_s2=True)
    gpu = ClipScorer.random_init(cfg, seed=3, dtype=torch.float32, device=cuda)
    cpu = ClipScorer(gpu.model.state_dict(), cfg=cfg, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(4)
    B, T, S = 2, 8, 96
    crops = rng.randint(0, 256, (B, T, S, S, 3), np.uint8)
    boxes = np.tile(np.array([100, 80, 100 + S, 80 + S], np.float32), (B, T, 1))
    lm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (B, T, 1, 1))
    valid = np.array([True, True])
    k1, k2 = warp_affine.launches, fused_bottleneck.launches
    got = gpu.score(crops, boxes, lm5, valid)
    assert warp_affine.launches == k1 + 1 and fused_bottleneck.launches == k2
    plain = gpu._score_impl(gpu._to_device(crops), gpu._to_device(boxes, torch.float32),
                            gpu._to_device(lm5, torch.float32), gpu._to_device(valid, torch.bool),
                            warp=warp_affine_reference).cpu().numpy()
    np.testing.assert_array_equal(got, plain)
    assert np.abs(got - cpu.score(crops, boxes, lm5, valid)).max() <= 1e-4


def _rotated_batch(rng, B, T, S, fmt="rgb"):
    shape = (B, T, S * 3 // 2, S) if fmt == "yuv420" else (B, T, S, S, 3)
    crops = rng.randint(0, 256, shape, np.uint8)
    boxes = np.tile(np.array([100, 80, 100 + S, 80 + S], np.float32), (B, T, 1))
    lm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (B, T, 1, 1))
    return crops, boxes, lm5 + rng.normal(0, 1.5, lm5.shape).astype(np.float32)


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_rounded_scorer_through_k1_matches_the_plain_warp(cuda, fmt):
    """``round_aligned_u8`` on the card: K1 once a batch, the probs equal
    to the same scorer's through K1's plain version (K1 is bit-exact, so
    the rounding sees the same values) and within 1e-4 of the CPU's."""
    cfg = I3DConfig(num_frames=8, crop_size=64)
    gpu = ClipScorer.random_init(cfg, seed=5, dtype=torch.float32, upload_format=fmt,
                                 device=cuda, round_aligned_u8=True)
    cpu = ClipScorer(gpu.model.state_dict(), cfg=cfg, dtype=torch.float32, upload_format=fmt,
                     device="cpu", round_aligned_u8=True)
    crops, boxes, lm5 = _rotated_batch(np.random.RandomState(6), 2, 8, 96, fmt)
    valid = np.array([True, True])
    k1 = warp_affine.launches
    got = gpu.score(crops, boxes, lm5, valid)
    assert warp_affine.launches == k1 + 1
    plain = gpu._score_impl(gpu._to_device(crops), gpu._to_device(boxes, torch.float32),
                            gpu._to_device(lm5, torch.float32), gpu._to_device(valid, torch.bool),
                            warp=warp_affine_reference).cpu().numpy()
    np.testing.assert_array_equal(got, plain)
    assert np.abs(got - cpu.score(crops, boxes, lm5, valid)).max() <= 1e-4


def test_score_index_on_card_matches_cpu(cuda):
    """A two-class head scored on its second logit, card against CPU."""
    cfg = I3DConfig(num_frames=8, crop_size=64, num_classes=2)
    gpu = ClipScorer.random_init(cfg, seed=7, dtype=torch.float32, device=cuda, score_index=1)
    cpu = ClipScorer(gpu.model.state_dict(), cfg=cfg, dtype=torch.float32, device="cpu",
                     score_index=1)
    crops, boxes, lm5 = _rotated_batch(np.random.RandomState(8), 2, 8, 96)
    valid = np.array([True, False])
    probs, logits, _ = gpu.score_with_features(crops, boxes, lm5, valid)
    np.testing.assert_allclose(probs[0], 1 / (1 + np.exp(-logits[0, 1])), atol=1e-6, rtol=0)
    assert probs[1] == 0.0
    assert np.abs(probs - cpu.score(crops, boxes, lm5, valid)).max() <= 1e-4


@pytest.mark.parametrize("shape,kernel,stride", [
    ((2, 256, 8, 14, 14), (1, 3, 3), (1, 1, 1)),     # an s4 middle convolution
    ((2, 512, 8, 28, 28), (1, 1, 1), (1, 2, 2)),     # s4's projection
    ((1, 12, 2, 5, 5), (3, 1, 1), (1, 1, 1)),        # M < 17, K and N padded
], ids=["s4_b", "s4_proj", "padded"])
def test_int8_accumulators_on_card_equal_the_plain_version(cuda, shape, kernel, stride):
    """cuBLASLt's int8 GEMM (``torch._int_mm``) over the im2col against a
    float64 convolution of the integers on the card (both exact)."""
    from stdd_torch.models import i3d

    g = torch.Generator(device=cuda).manual_seed(0)
    xq = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    xq = xq.contiguous(memory_format=torch.channels_last_3d)
    wq = torch.randint(-127, 128, (shape[1] // 2 + 3, shape[1]) + kernel, generator=g,
                       device=cuda, dtype=torch.int8)
    pad = tuple(k // 2 for k in kernel)
    acc = i3d.int8_conv_acc(xq, wq, stride, pad)
    assert acc.dtype == torch.int32 and acc.is_cuda
    torch.testing.assert_close(acc, i3d.int8_conv_acc_reference(xq, wq, stride, pad),
                               rtol=0, atol=0)


def test_int8_scorer_on_card_matches_cpu(cuda):
    """float32 int8 probs (s3-s5), card against CPU, and the bf16 int8
    scorer near its float scorer; the integer GEMM runs on every conv of
    s3-s5 (42 a forward)."""
    from stdd_torch.models import i3d

    rng = np.random.RandomState(0)
    B, T = 2, CFG.num_frames
    crops = rng.randint(0, 255, (B, T, 96, 96, 3)).astype(np.uint8)
    boxes = np.tile(np.array([5, 5, 90, 90], np.float32), (B, T, 1))
    lm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (B, T, 1, 1))
    valid = np.ones(B, bool)
    sd = ClipScorer.random_init(CFG, device="cpu").model.state_dict()
    probs = {}
    for where, dtype in (("cpu", torch.float32), (cuda, torch.float32), (cuda, torch.bfloat16)):
        s = ClipScorer(sd, cfg=CFG, dtype=dtype, device=where, int8=True)
        n0 = i3d.int8_conv_acc.launches
        probs[(str(where), dtype)] = s.score(crops, boxes, lm5, valid)
        assert i3d.int8_conv_acc.launches - n0 == 42
    ref = ClipScorer(sd, cfg=CFG, dtype=torch.bfloat16, device=cuda).score(crops, boxes, lm5,
                                                                           valid)
    cpu32, card32 = probs[("cpu", torch.float32)], probs[(str(cuda), torch.float32)]
    np.testing.assert_allclose(card32, cpu32, atol=1e-3)
    assert np.abs(probs[(str(cuda), torch.bfloat16)] - ref).max() < 0.05


def _dp_rank():
    """One rank of a two-rank job on one card (gloo carrying CUDA tensors):
    a float32 I3D step at world 2 and the same step at world 1."""
    import torch.distributed as dist

    from stdd_torch.models.i3d import I3D
    from stdd_torch.parallel.mesh import COLLECTIVES, DataParallel, local_rows
    from stdd_torch.train import engine_i3d as eng

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 4, 32, 32, 3).astype(np.float32)).to(dev)
    y = torch.tensor([0.0, 1.0, 1.0, 0.0], device=dev)
    res = {}
    for w, dp in ((1, None), (world, DataParallel(rank, world))):
        model = I3D(I3DConfig(num_frames=4, crop_size=32, width_per_group=16)).to(dev)
        args = eng.I3DTrainArgs(base_lr=0.01, max_epoch=1, warmup_epochs=0.5,
                                warmup_start_lr=0.0025, alter_freq=2, steps_per_epoch=4,
                                grad_clip=1.0)
        state, step, _ = eng.init_i3d_training(model, args, dp=dp)
        xs, ys = (x, y) if dp is None else (local_rows(x, rank, w), local_rows(y, rank, w))
        state, m = step(state, xs, ys, 0)
        res[w] = (float(m["loss"]), {k: v.double().cpu() for k, v in model.state_dict().items()})
    res["collectives"] = dict(COLLECTIVES)
    res["backend"] = dist.get_backend()
    return res


def test_data_parallel_step_on_one_card(cuda):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device, so the job picks gloo): the float32 world-2 step is the
    world-1 step within 1e-5."""
    from stdd_torch.parallel.mesh import spawn

    for res in spawn(_dp_rank, 2, device="cuda"):
        assert res["backend"] == "gloo"
        (l1, s1), (l2, s2) = res[1], res[2]
        assert abs(l1 - l2) <= 1e-5 * max(1.0, abs(l1))
        for k in s1:
            if s1[k].is_floating_point():
                err = float((s1[k] - s2[k]).abs().max()) / max(1.0, float(s1[k].abs().max()))
                assert err <= 1e-5, k
        assert res["collectives"]["all_reduce"] > 0


def test_mesh_world_1_over_nccl_is_the_plain_step(cuda):
    """``run_i3d --mesh`` on one card: world 1 over NCCL; its step (the
    gradient all-reduced over one rank) is the plain step."""
    import torch.distributed as dist

    from stdd_torch.models.i3d import I3D
    from stdd_torch.parallel.mesh import DataParallel, free_port, init_distributed
    from stdd_torch.train import engine_i3d as eng

    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        rng = np.random.RandomState(3)
        x = torch.from_numpy(rng.randn(2, 4, 32, 32, 3).astype(np.float32)).to(cuda)
        y = torch.tensor([0.0, 1.0], device=cuda)
        out = []
        for dp in (None, DataParallel(0, 1)):
            model = I3D(I3DConfig(num_frames=4, crop_size=32, width_per_group=16,
                                  dropout_rate=0.0)).to(cuda)
            args = eng.I3DTrainArgs(base_lr=0.01, max_epoch=1, warmup_epochs=0.5,
                                    warmup_start_lr=0.0025, alter_freq=2, steps_per_epoch=4,
                                    grad_clip=1.0)
            state, step, _ = eng.init_i3d_training(model, args, dp=dp)
            state, m = step(state, x, y, 0)
            out.append((float(m["loss"]), model.state_dict()))
        assert dist.get_backend() == "nccl"
    finally:
        dist.destroy_process_group()
    (l0, s0), (l1, s1) = out
    assert abs(l0 - l1) <= 1e-6
    for k in s0:
        if s0[k].is_floating_point():
            torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-6)


def test_relaid_convolutions_run_on_the_tensor_cores(cuda):
    """The bf16 I3D on the card: its stem through ``space_to_depth_conv3d``
    and a ``[3, 1, 1]`` convolution through ``temporal_conv3d_as_2d`` within
    bf16's rounding of a float64 convolution of the same bf16 operands, in
    ``channels_last_3d``; one forward re-lays its stem and every ``[kt, 1,
    1]`` convolution, once each (``Conv3dBN``'s counters), and its trace
    holds neither cuDNN's float32 fallback (``indexed_f32f32``) nor its
    NHWC→NCHW transpose."""
    from torch.profiler import ProfilerActivity, profile

    from stdd_torch.models.i3d import (I3D, Conv3dBN, fits_temporal_2d, space_to_depth_conv3d,
                                       temporal_conv3d_as_2d)

    bf, cl = torch.bfloat16, torch.channels_last_3d
    model = I3D(CFG, dtype=bf).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, CFG.num_frames, CFG.crop_size, CFG.crop_size, 3, generator=g, device=cuda)
    with torch.no_grad():
        xc = x.to(bf).permute(0, 4, 1, 2, 3)
        xa = torch.randn(1, 64, CFG.num_frames, 16, 16, generator=g, device=cuda).to(bf)
        xa = xa.contiguous(memory_format=cl)
        for conv, fn, xin in ((model.s1.pathway0_stem.conv, space_to_depth_conv3d, xc),
                              (model.s2.pathway0_res0.branch2.a.conv, temporal_conv3d_as_2d, xa)):
            w = conv.weight.to(bf, memory_format=cl)
            y = fn(xin, w, conv.stride, conv.padding)
            ref = F.conv3d(xin.double(), w.double(), None, conv.stride, conv.padding)
            assert y.dtype == bf and y.is_contiguous(memory_format=cl)
            assert float((y.double() - ref).abs().max() / ref.abs().max()) <= 2 ** -7
        model(x)
        torch.cuda.synchronize()
        n0 = Conv3dBN.s2d_convs, Conv3dBN.temporal_2d_convs
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    n_temporal = sum(fits_temporal_2d(m.conv.kernel_size, m.conv.stride, m.conv.padding)
                     for m in model.modules() if isinstance(m, Conv3dBN))
    assert n_temporal == 9
    assert (Conv3dBN.s2d_convs - n0[0], Conv3dBN.temporal_2d_convs - n0[1]) == (1, n_temporal)
    kernels = [k.name for e in prof.events() for k in e.kernels]
    assert kernels and not [k for k in kernels if "indexed_f32f32" in k or "nhwcToNchw" in k]


# K3 (ops/bias_act.py): (y shape [B, C, T, H, W], residual, relu); the I3D's
# and FTCN-TT's passes at score_dense's batch of 8, and ragged ones
K3_CASES = {
    "i3d_stem": ((8, 64, 32, 112, 112), False, True),
    "s2_last": ((8, 256, 32, 56, 56), True, True),
    "s5_last": ((8, 2048, 16, 7, 7), True, True),
    "ftcn_s4_shortcut": ((8, 1024, 16, 14, 14), False, False),
    "ragged_c24": ((3, 24, 5, 7, 9), True, True),
    "ragged_c8_no_relu": ((1, 8, 1, 3, 5), True, False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", list(K3_CASES), ids=list(K3_CASES))
def test_k3_equals_its_plain_version_bit_for_bit(cuda, case, dtype):
    from stdd_torch.ops.bias_act import bias_act, bias_act_reference

    shape, residual, relu = K3_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(5)
    y = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype)
    y = y.contiguous(memory_format=torch.channels_last_3d)
    b = torch.randn(shape[1], generator=g, device=cuda)
    r = torch.randn(shape, generator=g, device=cuda).to(dtype) if residual else None
    if r is not None:
        r = r.contiguous(memory_format=torch.channels_last_3d)
    want = bias_act_reference(y.clone(), b, r, relu)
    n0 = bias_act.launches
    got = bias_act(y, b, r, relu)
    torch.cuda.synchronize()
    assert got is y and bias_act.launches == n0 + 1
    assert torch.equal(got, want)


def test_k3_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from stdd_torch.ops.bias_act import bias_act

    cl = torch.channels_last_3d
    y = torch.zeros(2, 16, 3, 4, 4, dtype=torch.bfloat16, device=cuda).contiguous(memory_format=cl)
    b = torch.zeros(16, device=cuda)
    cases = [
        (y.float(), b, None),                                      # float32 y
        (y.contiguous(), b, None),                                 # C not innermost
        (torch.zeros(2, 12, 3, 4, 4, dtype=torch.bfloat16, device=cuda)
         .contiguous(memory_format=cl), torch.zeros(12, device=cuda), None),   # C % 8
        (y, b.double(), None),                                     # float64 bias
        (y, b, y.half()),                                          # residual's dtype
        (y, b, torch.zeros(2, 16, 3, 4, 5, dtype=torch.bfloat16, device=cuda)),  # shape
        (y, b, y.contiguous()),                                    # residual's layout
        (y, b, y),                                                 # overlapping y
        (y, b.cpu(), None),                                        # two devices
    ]
    for yy, bb, rr in cases:
        with pytest.raises(ValueError):
            bias_act(yy, bb, rr, True)


def _randomized(model, seed: int):
    """Random BN statistics and scales, so no residual branch is dead; each
    block's last BN small, so activations keep their scale."""
    from stdd_torch.models.i3d import Conv3dBN

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, Conv3dBN):
                n = m.bn.num_features
                lo, hi = (0.1, 0.3) if name.endswith(("branch2.c", ".c.Conv3dBN_0")) else (0.7, 1.3)
                m.bn.weight.copy_(torch.empty(n).uniform_(lo, hi, generator=g))
                m.bn.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.bn.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.bn.running_var.copy_(torch.empty(n).uniform_(0.7, 1.3, generator=g))
    return model


def _fold_forward(model, x, folded: bool):
    """The model's eval forward on the card, with BN folded (no gradient
    recorded: ``Conv3dBN.folds``) or as before (a gradient recorded); the
    output, and the folded convolutions and K3 launches it made."""
    from stdd_torch.models.i3d import Conv3dBN
    from stdd_torch.ops.bias_act import bias_act

    n0, k0 = Conv3dBN.folded_convs, bias_act.launches
    with torch.set_grad_enabled(not folded):
        out = model(x)
    out = (out[0] if isinstance(out, tuple) else out).detach().float()
    torch.cuda.synchronize()
    return out, Conv3dBN.folded_convs - n0, bias_act.launches - k0


# arch: the folded convolutions and K3 launches of one forward
FOLD_ARCHS = {"i3d_ori": (53, 49), "ftcn_tt": (43, 40)}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("arch", list(FOLD_ARCHS))
def test_folded_bf16_forward_agrees_with_the_unfused_one(cuda, arch):
    """The whole bf16 eval forward (16 logits a clip), BN folded, against
    the same forward unfused and the float32 forward: within 5% (relative
    L2) of the unfused logits, and no farther from float32's than the
    unfused ones are, with half a percent to spare (the fold rounds once
    where the unfused path rounds four or five times); the counters of one
    forward: 53 and 49 for the I3D-R50, 43 and 40 for FTCN-TT."""
    from stdd_torch.runtime.classifier import arch_config, build_model

    cfg = arch_config(arch, I3DConfig(num_frames=16, crop_size=64, num_classes=16))
    model = _randomized(build_model(arch, cfg), 6).to(cuda).eval()
    x = torch.randn(6, 16, 64, 64, 3, generator=torch.Generator().manual_seed(7)).to(cuda)
    f32, _, _ = _fold_forward(model, x, folded=True)            # float32: nothing folds
    model.compute_dtype = torch.bfloat16
    folded, n_conv, n_k3 = _fold_forward(model, x, folded=True)
    unfused, n_conv0, n_k30 = _fold_forward(model, x, folded=False)
    assert (n_conv, n_k3) == FOLD_ARCHS[arch] and (n_conv0, n_k30) == (0, 0)
    gaps = dict(folded_unfused=_rel(folded, unfused), folded_f32=_rel(folded, f32),
                unfused_f32=_rel(unfused, f32))
    assert gaps["folded_unfused"] <= 0.05, gaps
    assert gaps["folded_f32"] <= gaps["unfused_f32"] + 0.005, gaps


def test_fused_s2_int8_and_training_launch_no_k3_of_their_own(cuda):
    """``fused_s2``'s K2 blocks, the int8 stages and a training step fold
    nothing: the bf16 I3D with ``fused_s2`` folds the stem and s3-s5 only
    (53 − 10 convolutions, 49 − 9 passes); the bf16 int8 scorer (s3-s5)
    the stem and s2 only (11, 10); the float32 int8 scorer and a bf16
    training step nothing."""
    from stdd_torch.models.i3d import I3D, Conv3dBN
    from stdd_torch.ops.bias_act import bias_act

    x = torch.randn(2, 8, 64, 64, 3, generator=torch.Generator().manual_seed(8)).to(cuda)

    def counts(fn):
        n0, k0 = Conv3dBN.folded_convs, bias_act.launches
        fn()
        torch.cuda.synchronize()
        return Conv3dBN.folded_convs - n0, bias_act.launches - k0

    fused = I3D(I3DConfig(num_frames=8, crop_size=64, fused_s2=True), torch.bfloat16)
    fused = _randomized(fused, 9).to(cuda).eval()
    with torch.inference_mode():
        assert counts(lambda: fused(x)) == (43, 40)
    for dtype, want in ((torch.bfloat16, (11, 10)), (torch.float32, (0, 0))):
        s = ClipScorer.random_init(CFG, seed=1, dtype=dtype, device=cuda, int8=True)
        with torch.inference_mode():
            assert counts(lambda: s.model(x)) == want
    model = I3D(CFG, torch.bfloat16).to(cuda).train()
    gen = torch.Generator(device=cuda).manual_seed(12)

    def step():
        model(x, train=True, generator=gen).float().sum().backward()

    assert counts(step) == (0, 0)


@pytest.mark.parametrize("name", ["slowfast", "resunet"])
def test_slowfast_and_unet3d_fold_on_the_card(cuda, name):
    """The other users of ``Conv3dBN`` (stems, stages and SlowFast's fusion)
    fold too: their bf16 eval forward (SlowFast's 16 logits a clip, the
    ResUNet's masks), folded, within 5% (relative L2) of the unfused one and
    no farther from the float32 forward, with half a percent to spare."""
    from stdd_torch.models import build_model

    cfg = I3DConfig(num_frames=8, crop_size=64, num_classes=16)
    model = _randomized(build_model(name, cfg=cfg), 10).to(cuda).eval()
    x = torch.randn(2, 8, 64, 64, 3, generator=torch.Generator().manual_seed(11)).to(cuda)
    f32, _, _ = _fold_forward(model, x, folded=True)
    model.compute_dtype = torch.bfloat16
    folded, n_conv, n_k3 = _fold_forward(model, x, folded=True)
    unfused, _, _ = _fold_forward(model, x, folded=False)
    assert n_conv > 0 and n_k3 > 0
    gaps = dict(folded_unfused=_rel(folded, unfused), folded_f32=_rel(folded, f32),
                unfused_f32=_rel(unfused, f32))
    assert gaps["folded_unfused"] <= 0.05, gaps
    assert gaps["folded_f32"] <= gaps["unfused_f32"] + 0.005, gaps
