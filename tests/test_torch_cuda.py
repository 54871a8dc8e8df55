"""The port on an NVIDIA card: K1 against its plain version, the scorer on
the card against the same scorer on the CPU, and the device-resident ring
path (pushes and gathers on a side CUDA stream) against the host-packed path.

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
