#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stdd_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (any failed check raises, and the script then
exits non-zero without its result line):

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — K1 (``stdd_torch/csrc/warp_affine.cu``) and K2
              (``stdd_torch/csrc/fused_bottleneck.cu``) with nvcc for sm_90a,
              one nvcc each, started together, with their ptxas reports; and
              the native host helpers with g++;
3. K1       — the kernel against its plain PyTorch version on the card, in
              uint8 and float32, on the main path's shapes, an unaligned
              height, rotations up to ±45°, out-of-image taps, mixed
              geometries in one batch and rows of NaN/inf parameters; times
              (CUDA events, L2 cold; K1 also warm) beside the bound: K1 and
              the nearest single PyTorch call (``F.grid_sample``) in turns
              (K1, library, library, K1, repeated), every round printed with
              the SM clock and power nvidia-smi sampled beside it;
4. scorer   — the full-width I3D-R50 scorer (32×224², bf16, I420 upload,
              256-px crop buffer) on ring-style windows of different
              content: finite probs, the kernel against the plain warp
              through the whole scorer in float32, the bf16-vs-float32
              drift in probs, logits and pooled features (relative to how
              far two clips lie apart), and the device time of each stage;
5. engine   — the live path end to end at the bench's operating point
              (1080p, clip 32, stride 30, detect every 4, batch 2, I420,
              device-resident rings) on the scene oracle with one face:
              fps, window latency, K1 launches per dispatched batch, and one
              identical clip through the ring and the host-packed paths;
6. detector — the port's YuNet (ONNX reader → torch executor → decode →
              NMS) on a YuNet-shaped graph with yunet_n's layout and random
              weights (``"weights": "synthetic"``): head outputs and
              detections on the card against the same module on the CPU,
              and the times of detect at B = 1 and 4, the NMS on the host
              and ``detect_scaled`` from a 1080p frame; the heads' distance
              from the CPU and detect's time with TF32 on, which the app
              leaves off;
7. engine_detector — the engine phase again with ``detect_scaled`` on the
              card in the AsyncDetector, returning the oracle's rows
              (``"detections_real": false``): fps and window latency beside
              the oracle-only run, and how much of the detections' device
              time overlapped the scorer's;
8. server   — MultiStreamServer with 2 and 4 calls (a 1080p scene of its
              own seed each, one face), first shipping each window at once
              (the ring-mode default), then holding a window up to one
              round of the calls so clips of two calls share a batch: each
              stream's scores against a standalone engine's on the same
              frames, aggregate fps, window latency, clips per dispatched
              batch, batches that mix calls, and K1 launches per batch;
9. app      — RealtimeApp + run_loop, headless, over 180 scene frames with
              the engine_detector's detector: the meeting verdict, fps and
              the scored tracks;
10. K2      — the fused s2 bottleneck against its plain PyTorch version in
              bf16 (the tensor-core kernel) and float32 (the scalar kernel)
              at the serving shapes (block 0 with its projection, block 1
              identity; B = 1, 2 and score_dense's 8), tk = 1, and a ragged
              T/H/W, each case checked to have run its dtype's kernel; bf16
              times at B = 1, 2 and 8 with a cold L2 beside the bound, the
              achieved TFLOP/s, the plain version and the port's unfused
              cuDNN block;
11. fused scorer — a checkpoint written by the port's ``save_checkpoint``
              from the random-init scorer, served by ``from_jax_checkpoint``
              with ``I3DConfig(fused_s2=True)`` at 32×224² in bf16 and
              float32: K2 against its plain version through the whole
              float32 scorer, fused against unfused, bf16 against float32,
              and the I3D forward time fused beside unfused;
12. dense   — ``score_dense`` as the offline demo drives it
              (``stdd_tpu/eval/demo.py:188``): every stride-1 window of a
              300-frame (10 s at 30 fps) I420 track, batch 8, through the
              fused scorer: K2 and K1 launches per forward, dense against
              host-packed windows, windows per second beside the unfused
              scorer's on the same track;
13. train   — ``stdd_torch.train.run_i3d.main`` on the card at full width
              (I3D-R50, 32×224², bf16, batch 8) over a synthetic clip tree
              the script writes: two epochs over both AltFreezing phases
              with precise-BN, validation and checkpoints, then a third
              resumed from them; the loss must fall, K1 and K2 stay
              unlaunched; then on the last checkpoint the step's device
              time (CUDA events) and the profiler's busy share, peak
              memory, a frozen group across a phase, precise-BN on the
              stem, the host's cost per clip, and a float32 step on the
              card against the CPU's (``TRAIN_F32_TOLS``);
14. train_served — the trained checkpoint served unfused and through K2
              (3 launches a forward), as the fused scorer phase does, within
              ``TRAINED_TOLS``.

The K2 phases (10) run before the scorer (4) in the script, as they did.
Every measurement is printed as one JSON object per line; then the
``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX or stdd_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from stdd_torch.config import I3DConfig, PipelineConfig  # noqa: E402
from stdd_torch.eval.scene import Scene  # noqa: E402
from stdd_torch.native import available as native_available  # noqa: E402
from stdd_torch.models.i3d import ResBlock  # noqa: E402
from stdd_torch.ops import bottleneck as k2  # noqa: E402
from stdd_torch.ops.align import STD_POINTS_256  # noqa: E402
from stdd_torch.ops.bottleneck import fused_bottleneck, fused_bottleneck_reference  # noqa: E402
from stdd_torch.ops.warp import build_kernel, warp_affine, warp_affine_reference  # noqa: E402
from stdd_torch.runtime.classifier import ClipScorer, yuv420_to_rgb  # noqa: E402
from stdd_torch.models.yunet import YuNet, detect_scaled, resize_linear_u8  # noqa: E402
from stdd_torch.ops.nms import nms_fixed  # noqa: E402
from stdd_torch.runtime.app import RealtimeApp, run_loop  # noqa: E402
from stdd_torch.runtime.engine import AsyncDetector, StreamingEngine, _FrameEntry  # noqa: E402
from stdd_torch.runtime.packing import pack_clip_batch, pack_track  # noqa: E402
from stdd_torch.runtime.ring import DeviceRing, RingKernels  # noqa: E402
from stdd_torch.runtime.server import MultiStreamServer  # noqa: E402
from stdd_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from stdd_torch.utils.cuda_build import build_info  # noqa: E402
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph  # noqa: E402
from stdd_torch.utils.weights import i3d_torch_to_flax  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the float32 rate
# outside the tensor cores and the dense bf16 tensor-core rate; the L2 size,
# for timing with a cold L2
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
L2_BYTES = 50 * 2 ** 20
# ~flops per output pixel of K1: 2 coordinates (4 mul, 4 add), 2 floors and
# weights (6), 3 channels × (8 mul + 3 add)
K1_FLOPS_PER_PIXEL = 47
K1_TOL = 1e-3          # float32 evaluation order; the design is bit-exact
K1_PAIRS = 5           # K1 / grid_sample timing: 5 × (K1, lib, lib, K1) → 10 rounds each
# bounds of the scorer phase. The *_rel ones are fractions of how far two
# clips of different content lie apart through the float32 scorer (pooled
# features: the distance of the two feature vectors; logits: their gap), so
# a scorer that ignored its input could not meet them.
# The bf16 bounds are 3-5 times the drift measured on an H100 (1.4e-4 in
# prob, 0.020 of the feature distance, 0.011 of the logit gap).
TOLS = {
    "kernel_vs_plain_warp_f32_dp": 1e-6,        # K1 is bit-exact with the plain warp
    "kernel_vs_plain_warp_feature_rel": 1e-5,
    "bf16_vs_f32_dp": 5e-4,
    "bf16_vs_f32_feature_rel": 0.1,
    "bf16_vs_f32_logit_gap_rel": 0.05,
}
# |Δp| that two clips of different content must at least lie apart through
# the float32 scorer (measured: 0.012), so the weights depend on the input
SPREAD_MIN = 3e-3
# |Δp| of one clip through the ring windows and the host-packed path: the
# same pixels and geometry reach the bf16 scorer in both (per-frame scale
# folded into the warp vs geometry scaled per clip), so only rounding differs
WINDOW_TOL = 1e-4
# K2 against its plain version on the same operands (float32 sums in
# another order): float32 within 1e-5 of max(1, max |ref|) (measured 6e-7 on
# an H100); bf16 within two bf16 ulps of max |ref| — a float32 sum that lands
# on the other side of a rounding boundary moves xa, xb or y by one ulp —
# and on at most 1% of the elements (measured 0.09% at most)
K2_TOL_F32_REL = 1e-5
K2_TOL_BF16_ULPS = 2
K2_TOL_BF16_FRAC = 0.01
# the fused-s2 scorer's bounds. K2 against its plain version through the
# float32 scorer: they differ only in the order of float32 sums. Fused
# against unfused float32: the fold moves each weight by a float32 rounding.
# bf16 against float32: the unfused scorer's bounds (TOLS).
FUSED_TOLS = {
    "kernel_vs_plain_k2_f32_dp": 1e-5,
    "kernel_vs_plain_k2_feature_rel": 1e-4,
    "fused_vs_unfused_f32_dp": 1e-4,
    "bf16_vs_f32_dp": TOLS["bf16_vs_f32_dp"],
    "bf16_vs_f32_feature_rel": TOLS["bf16_vs_f32_feature_rel"],
    "bf16_vs_f32_logit_gap_rel": TOLS["bf16_vs_f32_logit_gap_rel"],
}
# |Δp| of the dense windows against the same windows packed on the host:
# the same bytes reach the same scorer in the same batches
DENSE_TOL = 1e-4
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps: int, rounds: int = 5, stream=None) -> float:
    """Device time of one ``fn()`` on ``stream`` (the current one when
    None): CUDA events around ``reps`` back-to-back calls, divided by
    ``reps``, median over ``rounds``, after one warm-up call. Inputs stay in
    L2 between calls where they fit in its 50 MB: a warm-L2 time."""
    times = []
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        for _ in range(rounds):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def cold_round_ms(fn, arg_sets, reps: int) -> float:
    """One round of ``cold_ms``: device time of one ``fn(*args)`` over
    ``reps`` back-to-back calls cycling through ``arg_sets``, every output
    alive until the round ends."""
    keep = []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for i in range(reps):
        keep.append(fn(*arg_sets[i % len(arg_sets)]))
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


class SmiSampler:
    """``nvidia-smi`` sampling the SM clock and power draw every 20 ms in a
    child process, read by a thread; ``near(t0, t1)`` gives the samples
    taken from 20 ms before host time ``t0`` to 20 ms after ``t1``."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "20"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), mhz, watts))

    def near(self, t0: float, t1: float):
        return [(mhz, w) for t, mhz, w in self.samples if t0 - 0.02 <= t <= t1 + 0.02]

    def close(self):
        self.proc.terminate()
        self.proc.wait()
        self.reader.join()


def interleaved_ms(fns: dict, arg_sets, reps: int, pairs: int, smi: SmiSampler) -> dict:
    """Cold rounds (``cold_round_ms``) of two functions in turns, A B B A
    repeated ``pairs`` times after one untimed round of each, so drift in
    the card's state falls on both alike. For each: every round's ms with
    the SM clock (MHz) and power (W) sampled beside it, and the min, median
    and max."""
    (na, fa), (nb, fb) = fns.items()
    for f in (fa, fb):
        cold_round_ms(f, arg_sets, reps)
    rounds = {na: [], nb: []}
    for _ in range(pairs):
        for name, f in ((na, fa), (nb, fb), (nb, fb), (na, fa)):
            t0 = time.perf_counter()
            ms = cold_round_ms(f, arg_sets, reps)
            near = smi.near(t0, time.perf_counter())
            rounds[name].append({"ms": ms, "sm_mhz": [m for m, _ in near],
                                 "power_w": [w for _, w in near]})
    out = {}
    for name, rs in rounds.items():
        ms = [r["ms"] for r in rs]
        out[name] = {"rounds": rs, "min": min(ms), "median": float(np.median(ms)), "max": max(ms)}
    return out


def cold_ms(fn, arg_sets, reps: int, rounds: int = 5) -> float:
    """Device time of one ``fn(*args)`` with a cold L2, to hold against the
    HBM bound: the back-to-back calls of a round (``cold_round_ms``) cycle
    through ``arg_sets``, whose inputs together are several times the L2,
    and every output of a round stays alive until the round ends, so no
    call finds its inputs in L2 or writes where an earlier call did. An
    untimed round first fills the allocator's cache. Median over
    ``rounds``."""
    cold_round_ms(fn, arg_sets, reps)
    return float(np.median([cold_round_ms(fn, arg_sets, reps) for _ in range(rounds)]))


# -- phase 3: K1 --------------------------------------------------------------

def similarity_params(rng, n, H, W, S, max_deg, scale=(0.9, 1.2), shift=(0.0, 0.0)):
    """[n, 8] dst→src affines of alignment-like similarities: rotation up
    to ``max_deg``, scale in ``scale``, centred on the crop plus ``shift``."""
    ang = np.radians(rng.uniform(-max_deg, max_deg, n))
    s = rng.uniform(*scale, n)
    c, sn = np.cos(ang) * s, np.sin(ang) * s
    cx = W / 2 + shift[0] + rng.uniform(-8, 8, n)
    cy = H / 2 + shift[1] + rng.uniform(-8, 8, n)
    # src = R·(p − S/2) + centre
    p = np.zeros((n, 8), np.float32)
    p[:, 0], p[:, 1], p[:, 3], p[:, 4] = c, -sn, sn, c
    p[:, 2] = cx - (c * S / 2 - sn * S / 2)
    p[:, 5] = cy - (sn * S / 2 + c * S / 2)
    return p


def k1_cases(rng, S=224):
    """(name, N, H, W, params [N,8]) — the geometries K1 must serve."""
    cases = [("main_B1", 32, 256, 256, similarity_params(rng, 32, 256, 256, S, 10)),
             ("main_B2", 64, 256, 256, similarity_params(rng, 64, 256, 256, S, 10)),
             # score_dense's batch of 8 clips
             ("dense_B8", 256, 256, 256, similarity_params(rng, 256, 256, 256, S, 10)),
             ("unaligned_H250", 8, 250, 256, similarity_params(rng, 8, 250, 256, S, 10)),
             ("rot45", 16, 256, 256, similarity_params(rng, 16, 256, 256, S, 45)),
             ("out_of_image", 8, 256, 256,
              similarity_params(rng, 8, 256, 256, S, 20, shift=(150.0, -120.0)))]
    mixed = np.concatenate([
        similarity_params(rng, 4, 256, 256, S, 5, scale=(0.4, 0.6)),
        similarity_params(rng, 4, 256, 256, S, 45, scale=(1.5, 2.5)),
        rng.uniform(-1.5, 1.5, (4, 8)).astype(np.float32) * [1, 1, 100, 1, 1, 100, 0, 0],
    ]).astype(np.float32)
    cases.append(("mixed", 12, 256, 256, mixed))
    bad = similarity_params(rng, 6, 256, 256, S, 10)
    bad[0, 2] = np.nan
    bad[1, 4] = np.inf
    bad[2, 0] = -np.inf
    bad[3, :6] = np.nan                # a padded slot: the whole fit is NaN
    bad[4, 5] = 1e30                   # huge finite coordinate
    bad[5, 2] = -1e30
    cases.append(("nonfinite", 6, 256, 256, bad))
    return cases


def phase_k1(dev):
    rng = np.random.RandomState(SEED)
    S = 224
    max_err = 0.0
    for name, N, H, W, params in k1_cases(rng, S):
        crops_u8 = torch.from_numpy(rng.randint(0, 256, (N, H, W, 3), np.uint8)).to(dev)
        p = torch.from_numpy(params).to(dev)
        for crops in (crops_u8, crops_u8.float()):
            got = warp_affine(crops, p, S)
            want = warp_affine_reference(crops, p, S)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"K1 {name}/{crops.dtype}: non-finite output")
            err = float((got - want).abs().max())
            emit({"phase": "k1_check", "case": name, "dtype": str(crops.dtype).replace("torch.", ""),
                  "N": N, "H": H, "W": W, "S": S, "max_abs_err": err, "tol": K1_TOL})
            if err > K1_TOL:
                raise AssertionError(f"K1 {name}/{crops.dtype}: max |Δ| {err} > {K1_TOL}")
            max_err = max(max_err, err)

    # timing at the main path's shapes: I420 upload → float32 crops after
    # yuv420_to_rgb; B=1 (N=32, one face) and B=2 (N=64, batch_clips=2).
    # ms / plain_ms / library_ms are cold-L2 times, held against the HBM
    # bound: K1 and the library call in turns (interleaved_ms), each round
    # printed with the SM clock and power beside it; ms_warm_l2 is K1
    # relaunched on one input set.
    timings = {}
    smi = SmiSampler()
    try:
        for N in (32, 64):
            timings[N] = k1_time(dev, rng, N, S, smi)
    finally:
        smi.close()
    return max_err, timings


def k1_time(dev, rng, N: int, S: int, smi: SmiSampler) -> dict:
    """K1 and ``F.grid_sample`` in turns with a cold L2 at N frames, its
    plain version and K1 with a warm L2; → the kernels-line numbers."""
    per_set = N * 256 * 256 * 3 * 4 + N * S * S * 3 * 4
    sets = []
    for _ in range(-(-4 * L2_BYTES // per_set) + 1):
        crops = torch.from_numpy(rng.randint(0, 256, (N, 256, 256, 3), np.uint8)).to(dev).float()
        p = torch.from_numpy(similarity_params(rng, N, 256, 256, S, 10)).to(dev)
        # the nearest single library call: grid_sample (bilinear, zero
        # padding) over the planar view with a precomputed sampling grid
        r = torch.arange(S, device=dev, dtype=torch.float32)[None, :, None]
        c = torch.arange(S, device=dev, dtype=torch.float32)[None, None, :]
        x = p[:, 0, None, None] * c + p[:, 1, None, None] * r + p[:, 2, None, None]
        y = p[:, 3, None, None] * c + p[:, 4, None, None] * r + p[:, 5, None, None]
        grid = torch.stack([x * (2.0 / 255) - 1, y * (2.0 / 255) - 1], -1)
        sets.append((crops, p, crops.permute(0, 3, 1, 2), grid))
    # rounds of about 5 ms, so each spans the nvidia-smi samples near it
    reps = len(sets) * max(4, round(5.0 / (0.03 * N / 32) / len(sets)))
    turns = interleaved_ms({
        "k1": lambda c, p, *_: warp_affine(c, p, S),
        "library": lambda c, p, planar, grid: F.grid_sample(
            planar, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
    }, sets, reps, K1_PAIRS, smi)
    ms, lib_ms = turns["k1"]["median"], turns["library"]["median"]
    warm_ms = event_ms(lambda: warp_affine(sets[0][0], sets[0][1], S), 50)
    plain_ms = cold_ms(lambda c, p, *_: warp_affine_reference(c, p, S), sets, 4 * len(sets))
    crops, p, planar, grid = sets[0]
    lib_err = float((F.grid_sample(planar, grid, align_corners=True).permute(0, 2, 3, 1)
                     - warp_affine_reference(crops, p, S)).abs().max())
    nbytes = crops.numel() * 4 + p.numel() * 4 + N * S * S * 3 * 4
    flops = K1_FLOPS_PER_PIXEL * N * S * S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "k1_time", "N": N, "H": 256, "W": 256, "S": S, "in_dtype": "float32",
          "bytes": nbytes, "flops": flops, **timing, "l2": "cold", "input_sets": len(sets),
          "launches_per_round": reps, "ms_warm_l2": warm_ms, "library": "F.grid_sample",
          "library_max_abs_diff": lib_err,
          "turns": "k1, library, library, k1, repeated; ms and library_ms are the medians",
          **{f"{k}_{stat}": turns[k][stat] for k in turns for stat in ("min", "max")}})
    for name, t in turns.items():
        emit({"phase": "k1_rounds", "N": N, "fn": name, "ms": [r["ms"] for r in t["rounds"]],
              "sm_mhz": [r["sm_mhz"] for r in t["rounds"]],
              "power_w": [r["power_w"] for r in t["rounds"]],
              "min": t["min"], "median": t["median"], "max": t["max"]})
    del sets
    return timing


# -- phase 4: scorer ----------------------------------------------------------

@torch.no_grad()
def randomize_bn(model, seed: int) -> None:
    """Random BN statistics and scales so no residual branch is dead (the
    default zero-init final BN scale would make every block an identity);
    the final BN of each block stays small so activations keep their scale
    through 16 residual blocks."""
    g = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm3d):
            n = m.num_features
            final = name.endswith("branch2.c.bn")
            lo, hi = (0.1, 0.3) if final else (0.7, 1.3)
            m.weight.copy_(torch.empty(n).uniform_(lo, hi, generator=g))
            m.bias.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_var.copy_(torch.empty(n).uniform_(0.7, 1.3, generator=g))


def clip_windows(rng, B, T, S):
    """B I420 ring windows [T, S*3//2, S] of different content: clip k draws
    its luma and chroma from its own ranges (full, dark and flat, bright,
    mid), so the clips' pooled features and probs differ."""
    looks = [((0, 256), 128), ((16, 96), 16), ((128, 250), 48), ((60, 200), 96)]
    ws = []
    for k in range(B):
        (lo, hi), a = looks[k % len(looks)]
        w = np.empty((T, S * 3 // 2, S), np.uint8)
        w[:, :S] = rng.randint(lo, hi, (T, S, S))
        w[:, S:] = rng.randint(128 - a, 128 + a, (T, S // 2, S))
        ws.append(w)
    return ws


def clip_geometry(rng, T, crop_px=300, S=256):
    """One track's per-frame (big box, crop-local lm5, pack scale): a face
    drifting by a pixel a frame with the template landmarks plus jitter."""
    boxes = np.zeros((T, 4), np.float32)
    lm5 = np.zeros((T, 5, 2), np.float32)
    for t in range(T):
        x, y = 400.0 + t, 200.0 + 0.5 * t
        boxes[t] = [x, y, x + crop_px, y + crop_px]
        lm5[t] = (STD_POINTS_256 * (crop_px / 2 / 256.0) + crop_px / 4
                  + rng.uniform(-1, 1, (5, 2)))
    scale = np.full((T,), min(1.0, S / crop_px), np.float32)
    return boxes, lm5, scale


def scorer_numbers(scorer, scorer32, ws, boxes, lm5, scale, valid) -> dict:
    """Probs of the bf16 and float32 scorers on the same windows, the kernel
    against the plain warp through the float32 scorer, and (for two or more
    clips) the same comparisons on the logits and pooled features, each
    relative to how far the first two clips lie apart in float32."""
    dev = scorer.device
    p16 = np.asarray(scorer.score_windows(ws, boxes, lm5, scale, valid))
    p32 = np.asarray(scorer32.score_windows(ws, boxes, lm5, scale, valid))
    crops = torch.stack(ws)
    b, l, sc = (torch.from_numpy(a).to(dev) for a in (boxes, lm5, scale))
    v = torch.from_numpy(valid).to(dev)
    pk = scorer32._score_impl(crops, b, l, v, scale=sc).cpu().numpy()
    pp = scorer32._score_impl(crops, b, l, v, scale=sc, warp=warp_affine_reference).cpu().numpy()
    res = {"probs_bf16": p16.tolist(), "probs_f32": p32.tolist(),
           "kernel_vs_plain_warp_f32_dp": float(np.abs(pk - pp).max()),
           "bf16_vs_f32_dp": float(np.abs(p16 - p32).max())}
    if len(ws) < 2:
        return res
    with torch.inference_mode():
        rgb = yuv420_to_rgb(crops)
        out = {}
        for key, model, warp in (("k32", scorer32.model, warp_affine),
                                 ("p32", scorer32.model, warp_affine_reference),
                                 ("k16", scorer.model, warp_affine)):
            x = (scorer32._align_batch(rgb, b, l, sc, warp) - scorer32._mean) / scorer32._std
            logits, feats = model(x, return_features=True)
            out[key] = (logits[:, 0].double().cpu(), feats.double().cpu())
    l32, f32 = out["k32"]
    apart = float((f32[0] - f32[1]).norm())
    d32 = float(l32[0] - l32[1])
    d16 = float(out["k16"][0][0] - out["k16"][0][1])
    res.update({
        "f32_logits": l32.tolist(), "bf16_logits": out["k16"][0].tolist(),
        "f32_prob_spread": float(abs(p32[0] - p32[1])),
        "f32_feature_distance": apart,
        "kernel_vs_plain_warp_feature_rel": float((out["p32"][1] - f32).norm(dim=1).max()) / apart,
        "bf16_vs_f32_feature_rel": float((out["k16"][1] - f32).norm(dim=1).max()) / apart,
        "bf16_vs_f32_logit_gap_rel": abs(d16 - d32) / abs(d32),
    })
    return res


def phase_scorer(dev):
    cfg = I3DConfig()
    T, S = cfg.num_frames, 256
    scorer = ClipScorer.random_init(cfg, seed=SEED, upload_format="yuv420", device=dev)
    randomize_bn(scorer.model, SEED)
    scorer32 = ClipScorer(scorer.model.state_dict(), cfg=cfg, dtype=torch.float32,
                          upload_format="yuv420", device=dev)
    rng = np.random.RandomState(SEED + 1)
    for B in (1, 2):
        ws = [torch.from_numpy(w).to(dev) for w in clip_windows(rng, B, T, S)]
        geo = [clip_geometry(rng, T) for _ in range(B)]
        boxes, lm5, scale = (np.stack([g[i] for g in geo]) for i in range(3))
        valid = np.ones((B,), bool)
        r = scorer_numbers(scorer, scorer32, ws, boxes, lm5, scale, valid)
        emit({"phase": "scorer", "B": B, **r, "tol": TOLS,
              "tf32": "off (cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False)"})
        p16 = np.array(r["probs_bf16"])
        if not (np.isfinite(p16).all() and ((p16 > 0) & (p16 < 1)).all()):
            raise AssertionError(f"scorer B={B}: probs {p16} not finite in (0, 1)")
        check_scorer(r, B)
        crops = torch.stack(ws)
        b, l, sc = (torch.from_numpy(a).to(dev) for a in (boxes, lm5, scale))
        emit({"phase": "scorer_stages", "B": B, "dtype": "bfloat16",
              **stage_times(scorer, crops, b, l, sc)})
    return scorer


def check_scorer(r: dict, B: int) -> None:
    for key, tol in TOLS.items():
        if key in r and not r[key] <= tol:
            raise AssertionError(f"scorer B={B}: {key} {r[key]} > {tol}")
    if "f32_prob_spread" in r and not r["f32_prob_spread"] >= SPREAD_MIN:
        raise AssertionError(f"scorer B={B}: two clips of different content give probs only "
                             f"{r['f32_prob_spread']} apart (< {SPREAD_MIN}): the weights "
                             "do not depend on the input")


@torch.inference_mode()
def stage_times(scorer, crops, boxes, lm5, scale) -> dict:
    """Device time (ms, CUDA events, median) of each stage of one scorer
    call on device-resident windows, and of the whole call."""
    from stdd_torch.ops.align import clip_geometry as fit_geometry, similarity_cv2
    from stdd_torch.ops.warp import pack_warp_params

    B, T = crops.shape[:2]
    S = scorer.cfg.crop_size
    rgb = yuv420_to_rgb(crops)

    def solve():
        diffs, pts = fit_geometry(boxes, lm5)
        tfm, _ = similarity_cv2(pts.flatten(-3, -2), scorer._template.repeat(T, 1))
        return (pack_warp_params(tfm, diffs) * scale[..., None]).reshape(B * T, 8)

    params = solve()
    flat_rgb = rgb.reshape((B * T,) + rgb.shape[2:])
    aligned = warp_affine(flat_rgb, params, S).reshape(B, T, S, S, 3)
    x = (aligned - scorer._mean) / scorer._std
    valid = torch.ones(B, dtype=torch.bool, device=crops.device)
    return {
        "yuv420_to_rgb_ms": event_ms(lambda: yuv420_to_rgb(crops), 20),
        "similarity_solve_ms": event_ms(solve, 20),
        "k1_warp_ms": event_ms(lambda: warp_affine(flat_rgb, params, S), 20),
        "normalize_ms": event_ms(lambda: (aligned - scorer._mean) / scorer._std, 20),
        "i3d_forward_ms": event_ms(lambda: scorer.model(x), 20),
        "score_impl_ms": event_ms(lambda: scorer._score_impl(crops, boxes, lm5, valid,
                                                            scale=scale), 20),
    }


# -- phase 5: engine ----------------------------------------------------------

def window_vs_packed_delta(scorer, pipe, crop_buffer: int) -> float:
    """|Δp| of ONE identical clip through the device-ring windows path and
    the host-packed path (bench.py's self-certification probe)."""
    T = pipe.clip_size
    rng = np.random.RandomState(7)
    ring = DeviceRing(RingKernels(R=T, S=crop_buffer, yuv420=True, device=scorer.device))
    entries = []
    for i in range(T):
        crop = rng.randint(0, 255, (300, 280, 3), np.uint8)   # pack scale < 1
        box = np.array([40.0 + i, 30.0, 320.0 + i, 330.0], np.float32)
        lm5 = (STD_POINTS_256 * (200.0 / 256.0) + np.array([40.0, 60.0]) + 0.5 * i).astype(np.float32)
        ring.push(crop, box, lm5)
        entries.append(_FrameEntry(crop, box, lm5))
    dev, b, l, s = ring.window(T)
    p_ring = np.asarray(scorer.score_windows([dev], b[None], l[None], s[None], np.array([True])))
    crops, boxes, lm5b, valid = pack_clip_batch([entries], 1, T, crop_buffer, yuv420=True)
    p_packed = scorer.score(crops, boxes, lm5b, valid)
    return float(abs(p_ring[0] - p_packed[0]))


ENGINE_PIPE = dict(clip_size=32, stride=30, detect_every=4, batch_clips=2, min_face_side=10)
ENGINE_KW = dict(crop_buffer=256, q_weighting=False, q_lap_hard=0.0, start_conf=0.3,
                 track_kwargs=dict(track_thresh=0.35, match_thresh=0.6, track_buffer=2000,
                                   split_low_scores=False))
ENGINE_WARM, ENGINE_FRAMES = 70, 240


def engine_numbers(eng, scored, dt, n_frames, launches, batches) -> dict:
    """fps, window latency and K1 launches of one timed engine or server run."""
    probs = np.array([p for _, p in scored], np.float64)
    lats = 1000.0 * np.asarray(eng.clip_latencies, np.float64)
    if not scored:
        raise AssertionError("no clip was scored")
    if not np.isfinite(probs).all():
        raise AssertionError(f"non-finite scores: {probs}")
    if launches == 0 or launches != batches:
        raise AssertionError(f"K1 launches {launches} != dispatched batches {batches}")
    return {"frames": n_frames, "fps": n_frames / dt, "clips_scored": len(scored),
            "batches_dispatched": batches, "k1_launches": launches,
            "k1_launches_per_batch": launches / batches,
            "window_latency_p50_ms": float(np.percentile(lats, 50)) if lats.size else None,
            "window_latency_p95_ms": float(np.percentile(lats, 95)) if lats.size else None}


def drive_engine(scorer, frames, detect_fn) -> dict:
    """The live path at the bench's operating point (``bench.py:215-263``):
    warm-up, then ``ENGINE_FRAMES`` timed frames with K1's count zeroed
    just before and read just after."""
    eng = StreamingEngine(scorer, AsyncDetector(detect_fn), cfg=PipelineConfig(**ENGINE_PIPE),
                          **ENGINE_KW)
    if not eng.device_resident:
        raise AssertionError("engine did not take the device-resident ring path")
    try:
        eng.warmup()
        for i in range(ENGINE_WARM):
            eng.step(frames[i])
        eng.flush()
        eng.clip_latencies.clear()
        seq0 = eng._group._next_seq
        warp_affine.launches = 0                      # the path's run starts here
        scored = []
        t0 = time.perf_counter()
        for i in range(ENGINE_WARM, ENGINE_WARM + ENGINE_FRAMES):
            scored += eng.step(frames[i])
        scored += eng.flush()
        dt = time.perf_counter() - t0
        launches = warp_affine.launches                # ... and ends here
        batches = eng._group._next_seq - seq0
    finally:
        eng.close()
    res = engine_numbers(eng, scored, dt, ENGINE_FRAMES, launches, batches)
    res["tracks"] = len(eng.track_clip_scores)
    return res


def phase_engine(scorer, smi, scene, frames):
    pipe = PipelineConfig(**ENGINE_PIPE)
    res = {"phase": "engine", "card": smi, "detector": "scene oracle",
           **drive_engine(scorer, frames, scene.oracle(pipe.detect_every))}
    delta = window_vs_packed_delta(scorer, pipe, ENGINE_KW["crop_buffer"])
    res["window_vs_packed_score_delta"] = delta
    res["window_vs_packed_tol"] = WINDOW_TOL
    emit(res)
    if not delta <= WINDOW_TOL:
        raise AssertionError(f"ring window vs packed clip |Δp| {delta} > {WINDOW_TOL}")
    # frames per K1 launch on the main path: clip_size × clips per batch
    return res, pipe.clip_size * round(res["clips_scored"] / res["batches_dispatched"])


# -- phase 6: the YuNet detector ----------------------------------------------

# the detector on the card against the same module on the CPU, float32 and
# TF32 off: head outputs (sigmoids, box and landmark offsets of order one)
# within 1e-4 — cuDNN and the CPU sum the convolutions in other orders;
# rows within 1e-3 px and 1e-5 in score, and the same rows kept
DET_TOLS = {"head_abs": 1e-4, "rows_px": 1e-3, "rows_score": 1e-5}


def wall_ms(fn, n: int) -> float:
    """Median host wall time (ms) of ``fn()`` over ``n`` calls after one
    warm-up; ``fn`` returns host data, so each call ends when its work has."""
    fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1000.0 * float(np.median(ts))


def phase_detector(dev, tmp_dir, smi):
    """The port's YuNet on the YuNet-shaped graph (``stdd_torch/utils/
    onnx_writer.py``: yunet_n's layout, random weights from SEED, written as
    ONNX and read back through the port's reader) → the detector on the
    card."""
    path = write_onnx(yunet_shaped_graph(SEED), os.path.join(tmp_dir, "yunet_shaped.onnx"))
    det = YuNet(path, device=dev)
    ref = YuNet(path, device="cpu")
    full = [Scene((1080, 1920), n_faces=1, seed=SEED + k).frame(10 * k) for k in range(4)]
    small = np.stack([resize_linear_u8(torch.from_numpy(f), 320, 320).numpy() for f in full])
    blob = torch.from_numpy(small).float().permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        heads_card = {k: v.cpu() for k, v in det.module(blob[:1].to(dev)).items()}
        heads_cpu = ref.module(blob[:1])
        _, scores, _ = ref._decode_one(heads_cpu, 320, 320)
    head_err = max(float((heads_card[k] - heads_cpu[k]).abs().max()) for k in heads_cpu)
    dets, mask = det.detect(small)
    dets_cpu, mask_cpu = ref.detect(small)
    same_rows = bool((mask == mask_cpu).all())
    px_err = score_err = 0.0
    if same_rows:
        d, r = dets[mask], dets_cpu[mask_cpu]
        px_err = float(np.abs(d[:, :14] - r[:, :14]).max())
        score_err = float(np.abs(d[:, 14] - r[:, 14]).max())
    # the NMS alone, on frame 0's decoded anchors: one copy to the host and
    # the loop there, as the detector runs it
    x = blob.to(dev)
    torch.cuda.synchronize()                  # x was copied on the default stream
    with torch.cuda.stream(det.stream), torch.inference_mode():
        boxes, sc, _ = det._decode_one(det.module(x[:1]), 320, 320)
        torch.cuda.current_stream().synchronize()
    host = (boxes.cpu(), sc.cpu())
    args = (det.nms_threshold, det.conf_threshold, det.top_k)
    _, ok_h = nms_fixed(*host, *args)
    # what TF32 would change: the app runs the detector with it off (as
    # here); the heads' distance from the CPU and detect's time with it on
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            heads_tf32 = {k: v.cpu() for k, v in det.module(blob[:1].to(dev)).items()}
        tf32_err = max(float((heads_tf32[k] - heads_cpu[k]).abs().max()) for k in heads_cpu)
        tf32_ms = wall_ms(lambda: det.detect(small[:1]), 20)
    finally:
        torch.backends.cudnn.allow_tf32 = False

    def forward(b):
        with torch.inference_mode():
            for i in range(b):
                det._decode_one(det.module(x[i:i + 1]), 320, 320)

    res = {"phase": "detector", "card": smi, "weights": "synthetic",
           "graph": "yunet_shaped_graph (yunet_n layout, random weights, seed %d)" % SEED,
           "anchors": int(sc.numel()), "anchors_over_conf": int((scores > 0.6).sum()),
           "kept": [int(m.sum()) for m in mask],
           "head_max_abs_err_card_vs_cpu": head_err, "same_rows_card_vs_cpu": same_rows,
           "rows_px_err": px_err, "rows_score_err": score_err, "tol": DET_TOLS,
           "detect_b1_ms": wall_ms(lambda: det.detect(small[:1]), 20),
           "detect_b4_ms": wall_ms(lambda: det.detect(small), 10),
           "forward_decode_device_b1_ms": event_ms(lambda: forward(1), 10, stream=det.stream),
           "forward_decode_device_b4_ms": event_ms(lambda: forward(4), 5, stream=det.stream),
           "nms_host_ms": wall_ms(lambda: nms_fixed(*host, *args), 20),
           "nms_kept": int(ok_h.sum()),
           "tf32_head_max_abs_err_vs_cpu": tf32_err, "tf32_detect_b1_ms": tf32_ms,
           "resize_device_1080p_ms": event_ms(
               lambda: resize_linear_u8(torch.from_numpy(full[0]).to(dev), 320, 320), 10,
               stream=det.stream),
           "detect_scaled_1080p_ms": wall_ms(lambda: [detect_scaled(det, f) for f in full],
                                             5) / len(full)}
    emit(res)
    if not (head_err <= DET_TOLS["head_abs"] and same_rows and px_err <= DET_TOLS["rows_px"]
            and score_err <= DET_TOLS["rows_score"]):
        raise AssertionError(f"detector card vs CPU: heads {head_err}, same rows {same_rows}, "
                             f"px {px_err}, score {score_err} (tol {DET_TOLS})")
    if not (res["anchors_over_conf"] >= 10 and min(res["kept"]) >= 1):
        raise AssertionError(f"the synthetic detector is vacuous: {res['anchors_over_conf']} "
                             f"anchors over 0.6, kept {res['kept']}")
    return det


# -- phase 7: the engine with the detector on the card ---------------------------

class DeviceSpans:
    """Device-time intervals of work on several streams, from CUDA events
    recorded on each stream before and after it; ``ms()`` gives them in ms
    from the base event, and ``overlap_ms`` the time two sets share."""

    def __init__(self):
        torch.cuda.synchronize()
        self.base = torch.cuda.Event(enable_timing=True)
        self.base.record()
        self.spans = {}

    @staticmethod
    def record():
        """An event on the current stream."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, key, start, end):
        self.spans.setdefault(key, []).append((start, end))

    def ms(self, key):
        torch.cuda.synchronize()
        return [(self.base.elapsed_time(a), self.base.elapsed_time(b))
                for a, b in self.spans.get(key, [])]

    def overlap_ms(self, a, b) -> float:
        others = self.ms(b)
        total = 0.0
        for s, e in self.ms(a):
            cuts = sorted((max(s, s2), min(e, e2)) for s2, e2 in others if s2 < e and e2 > s)
            end = s
            for c0, c1 in cuts:                     # union of the cuts within [s, e]
                c0 = max(c0, end)
                if c1 > c0:
                    total += c1 - c0
                    end = c1
        return total


def detector_fn(det, scene, detect_every, spans=None):
    """The engine's detector for the synthetic weights: ``detect_scaled``
    runs on every frame it is given, for its device cost, and the scene
    oracle's rows come back, so tracking stays meaningful. With ``spans``
    each detection's device interval on the detector's stream is kept."""
    oracle = scene.oracle(detect_every)

    def detect_fn(frame):
        if spans is not None:
            with torch.cuda.stream(det.stream):
                start = spans.record()
        detect_scaled(det, frame)
        if spans is not None:
            with torch.cuda.stream(det.stream):
                spans.add("detect", start, spans.record())
        return oracle(frame)

    return detect_fn


def phase_engine_detector(scorer, det, smi, scene, frames, engine_res):
    """The ``engine`` phase's operating point with the detector's device
    cost on the path: fps and window latency beside the oracle-only run of
    the same call, and how much of the detections' device time overlapped
    the scorer's (the detector runs on its own CUDA stream)."""
    spans = DeviceSpans()
    orig = scorer._score_impl

    def timed(*a, **k):
        start = spans.record()
        out = orig(*a, **k)
        spans.add("score", start, spans.record())
        return out

    scorer._score_impl = timed
    try:
        res = drive_engine(scorer, frames, detector_fn(det, scene, ENGINE_PIPE["detect_every"],
                                                       spans))
    finally:
        del scorer._score_impl
    det_ms = [e - s for s, e in spans.ms("detect")]
    overlap = spans.overlap_ms("detect", "score")
    out = {"phase": "engine_detector", "card": smi, "detections_real": False,
           "detector": "detect_scaled on the card (synthetic weights), oracle rows returned",
           **res, "oracle_fps": engine_res["fps"],
           "oracle_window_latency_p50_ms": engine_res["window_latency_p50_ms"],
           "oracle_window_latency_p95_ms": engine_res["window_latency_p95_ms"],
           "fps_ratio_vs_oracle": res["fps"] / engine_res["fps"],
           "detections": len(det_ms), "detect_device_ms_median": float(np.median(det_ms)),
           "score_device_ms_median": float(np.median([e - s for s, e in spans.ms("score")])),
           "detect_overlapping_score_ms": overlap,
           "detect_overlap_share": overlap / max(sum(det_ms), 1e-9)}
    emit(out)
    return out


# -- phase 8: multi-stream serving ----------------------------------------------

# a stream's scores through the server against the same frames through a
# standalone engine: the same clips in batches of other composition, whose
# bf16 convolutions may take other cuDNN algorithms; bounded by the
# bf16-vs-float32 drift bound of the scorer phase
SERVER_TOL = 5e-4
SERVER_FRAMES = 150


def run_server(scorer, smi, pipe, scenes, frames, n, wait):
    """n calls through one ``MultiStreamServer`` (``max_batch_wait_frames``
    = ``wait``), stepped round-robin from one thread after its warm-up; K1's
    count is zeroed just before and read just after. Each dispatched batch
    records how many calls its clips came from."""
    server = MultiStreamServer(scorer, cfg=pipe, max_batch_wait_frames=wait, **ENGINE_KW)
    try:
        server.warmup()
        sids = [server.add_stream(scenes[k].oracle(pipe.detect_every)) for k in range(n)]
        got = {sid: [] for sid in sids}
        group = server._root._group
        owners_per_batch = []
        dispatch = group._dispatch

        def spy():
            with group._state_lock:
                batch = group.pending[:group.cfg.batch_clips]
                if batch:
                    owners_per_batch.append(len({id(c.owner) for c in batch}))
                dispatch()

        group._dispatch = spy
        seq0 = group._next_seq
        warp_affine.launches = 0                       # the server's run starts here
        t0 = time.perf_counter()
        for i in range(SERVER_FRAMES):
            for k, sid in enumerate(sids):
                got[sid] += server.step(sid, frames[k][i])
        for sid in sids:
            got[sid] += server.flush(sid)
        dt = time.perf_counter() - t0
        launches = warp_affine.launches                # ... and ends here
        batches = group._next_seq - seq0
        scored = [x for sid in sids for x in got[sid]]
        res = {"phase": "server", "card": smi, "streams": n,
               "max_batch_wait_frames": wait,
               **engine_numbers(server._root, scored, dt, n * SERVER_FRAMES, launches,
                                batches)}
    finally:
        server.close()
    res.update({"frames_per_stream": SERVER_FRAMES,
                "clips_per_batch": res["clips_scored"] / res["batches_dispatched"],
                "batches_mixing_calls": sum(k > 1 for k in owners_per_batch)})
    return res, [got[sid] for sid in sids]


def phase_server(scorer, smi) -> dict:
    """``MultiStreamServer`` with 2, then 4 concurrent calls, each a
    1080p scene of its own seed with one face, at the engine phase's
    operating point: windows shipped at once (``max_batch_wait_frames`` 0,
    the ring-mode default: one clip a batch), then held for up to one
    round of the calls (n group steps), so the calls' windows, which fall
    due on the same frame, share batches and their scores are routed back
    by owner."""
    pipe = PipelineConfig(**ENGINE_PIPE)
    scenes = [Scene((1080, 1920), n_faces=1, seed=SEED + 10 + k) for k in range(4)]
    frames = [[s.frame(i) for i in range(SERVER_FRAMES)] for s in scenes]
    solo = []
    for k, s in enumerate(scenes):
        eng = StreamingEngine(scorer, s.oracle(pipe.detect_every), cfg=pipe, **ENGINE_KW)
        try:
            out = []
            for f in frames[k]:
                out += eng.step(f)
            out += eng.flush()
        finally:
            eng.close()
        solo.append(out)
    results = {}
    for wait in ("stride", "round"):
        for n in (2, 4):
            res, got = run_server(scorer, smi, pipe, scenes, frames, n,
                                  n if wait == "round" else wait)
            dp = 0.0
            for k, have in enumerate(got):
                want = solo[k]
                if [t for t, _ in have] != [t for t, _ in want]:
                    raise AssertionError(f"server, {n} streams, wait {wait}: stream {k} scored "
                                         "other clips than its standalone engine")
                dp = max(dp, float(np.abs(np.subtract([p for _, p in have],
                                                      [p for _, p in want])).max()))
            res.update({"vs_standalone_max_dp": dp, "tol": SERVER_TOL})
            emit(res)
            if not dp <= SERVER_TOL:
                raise AssertionError(f"server, {n} streams, wait {wait}: |Δp| vs standalone "
                                     f"{dp} > {SERVER_TOL}")
            if wait == "round" and not (res["clips_per_batch"] > 1
                                        and res["batches_mixing_calls"] > 0):
                raise AssertionError(f"server, {n} streams held a round: no batch mixed calls "
                                     f"({res['clips_per_batch']} clips a batch)")
            results[(n, wait)] = res
    return results


# -- phase 9: the live app -------------------------------------------------------

APP_FRAMES = 180


def phase_app(scorer, det, smi, scene, frames) -> dict:
    """``RealtimeApp`` + ``run_loop``, headless, over the scene's frames,
    with the engine_detector phase's detector."""
    pipe = PipelineConfig(**ENGINE_PIPE)
    eng = StreamingEngine(scorer, AsyncDetector(detector_fn(det, scene, pipe.detect_every)),
                          cfg=pipe, **ENGINE_KW)
    app = RealtimeApp(eng, threshold=pipe.threshold)
    try:
        eng.warmup()
        seq0 = eng._group._next_seq
        warp_affine.launches = 0                       # the app's run starts here
        t0 = time.perf_counter()
        ready, fake = run_loop(app, iter(frames[:APP_FRAMES]))
        dt = time.perf_counter() - t0
        launches = warp_affine.launches                # ... and ends here
        batches = eng._group._next_seq - seq0
    finally:
        eng.close()
    scores = {int(t): [float(p) for p in s] for t, s in app.running_scores.items()}
    res = {"phase": "app", "card": smi, "detections_real": False, "frames": APP_FRAMES,
           "fps": APP_FRAMES / dt, "meeting_ready": bool(ready), "meeting_fake": bool(fake),
           "scored_tracks": scores, "k1_launches": launches, "batches_dispatched": batches,
           "frames_seen": app.frames_seen}
    emit(res)
    flat = [p for s in scores.values() for p in s]
    if not (ready and flat and np.isfinite(flat).all() and launches == batches > 0):
        raise AssertionError(f"app: ready {ready}, scores {scores}, K1 launches {launches}, "
                             f"batches {batches}")
    return res


# -- phase 10: K2 --------------------------------------------------------------

def k2_operands(rng, B, T, H, W, cin, co, tk, project, dev, dtype):
    """x [B, Cin, T, H, W] (channels_last_3d, ``dtype``) and the BN-folded
    float32 operands of one bottleneck, fan-in scaled so the activations
    keep the magnitude of a trained block's."""
    ci = k2.KERNEL_CI

    def w(*shape):
        fan = int(np.prod(shape[:-1]))
        return torch.from_numpy((rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)).to(dev)

    def b(n):
        return torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32)).to(dev)

    x = torch.from_numpy(rng.randn(B, T, H, W, cin).astype(np.float32)).to(dev)
    ops = [w(tk, cin, ci), b(ci), w(3, 3, ci, ci), b(ci), w(ci, co), b(co)]
    ops += [w(cin, co), b(co)] if project else [None, None]
    return x.permute(0, 4, 1, 2, 3).to(dtype), ops


# (name, B, T, H, W, Cin, Co, tk, projection): the serving shapes of s2's
# blocks (block 0: 64 → 256 with its projection; blocks 1-2: 256 → 256) at
# the engine's batches and score_dense's 8, tk = 1, and a T/H/W the 14 × 14
# tiles do not divide
K2_CASES = [("block0_B1", 1, 32, 56, 56, 64, 256, 3, True),
            ("block0_B2", 2, 32, 56, 56, 64, 256, 3, True),
            ("block0_B8", 8, 32, 56, 56, 64, 256, 3, True),
            ("block1_B1", 1, 32, 56, 56, 256, 256, 3, False),
            ("block1_B2", 2, 32, 56, 56, 256, 256, 3, False),
            ("block1_B8", 8, 32, 56, 56, 256, 256, 3, False),
            ("tk1_projection", 1, 8, 20, 17, 64, 128, 1, True),
            ("ragged", 2, 5, 15, 30, 256, 256, 3, False)]


@torch.inference_mode()
def phase_k2_check(dev) -> float:
    rng = np.random.RandomState(SEED + 2)
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, T, H, W, cin, co, tk, project in K2_CASES:
            x, ops = k2_operands(rng, B, T, H, W, cin, co, tk, project, dev, dtype)
            before = dict(fused_bottleneck.launches_by_kernel)
            got = fused_bottleneck(x, *ops, tk=tk)
            ran = [k for k, n in fused_bottleneck.launches_by_kernel.items() if n != before[k]]
            want = fused_bottleneck_reference(x, *ops, tk=tk)
            torch.cuda.synchronize()
            if ran != [k2.KERNELS[dtype]]:
                raise AssertionError(f"K2 {name}/{dtype}: ran {ran}, not {k2.KERNELS[dtype]}")
            ok_layout = got.is_contiguous(memory_format=torch.channels_last_3d)
            err = float((got.float() - want.float()).abs().max())
            ref_max = float(want.float().abs().max())
            rec = {"phase": "k2_check", "case": name, "dtype": str(dtype).replace("torch.", ""),
                   "B": B, "T": T, "H": H, "W": W, "Cin": cin, "Co": co, "tk": tk,
                   "projection": project, "kernel": ran[0], "max_abs_err": err,
                   "max_abs_ref": ref_max}
            if dtype == torch.float32:
                tol = K2_TOL_F32_REL * max(1.0, ref_max)
            else:
                tol = K2_TOL_BF16_ULPS * 2.0 ** (np.floor(np.log2(ref_max)) - 7)
                rec["frac_differing"] = float((got != want).float().mean())
                rec["frac_tol"] = K2_TOL_BF16_FRAC
            rec["tol"] = tol
            emit(rec)
            if not (torch.isfinite(got).all() and ok_layout):
                raise AssertionError(f"K2 {name}/{dtype}: non-finite output or not channels_last_3d")
            if err > tol or rec.get("frac_differing", 0.0) > K2_TOL_BF16_FRAC:
                raise AssertionError(f"K2 {name}/{dtype}: max |Δ| {err} (tol {tol}), "
                                     f"{rec.get('frac_differing')} of elements differ")
            max_err = max(max_err, err)
    return max_err


def k2_work(B, T, H, W, cin, co, tk, project, itemsize=2):
    """Bytes K2 must move (x read once, y written once, weights and biases)
    and the flops of its products, for one call."""
    P = B * T * H * W
    ci = k2.KERNEL_CI
    macs = tk * cin * ci + 9 * ci * ci + ci * co + (cin * co if project else 0)
    weights = macs * itemsize + (2 * ci + co + (co if project else 0)) * 4
    return P * (cin + co) * itemsize + weights, 2 * P * macs


@torch.inference_mode()
def phase_k2_time(dev) -> dict:
    """Cold-L2 times (``cold_ms``) of K2, its plain version and the port's
    unfused cuDNN ResBlock on the same bf16 input, at the serving shapes and
    B = 1, 2 and 8 (``score_dense``'s batch). No single PyTorch call
    computes a whole bottleneck, so there is no library time."""
    rng = np.random.RandomState(SEED + 3)
    T, H, W, co = 32, 56, 56, 256
    timings = {}
    for B in (1, 2, 8):
        for name, cin, project in (("block0", 64, True), ("block1", 256, False)):
            nbytes, flops = k2_work(B, T, H, W, cin, co, 3, project)
            per_set = B * T * H * W * (cin + co) * 2
            n_sets = -(-4 * L2_BYTES // per_set) + 1
            sets = []
            for _ in range(n_sets):
                x, ops = k2_operands(rng, B, T, H, W, cin, co, 3, project, dev, torch.bfloat16)
                # the model hands K2 weights already cast (ResBlock.folded_weights)
                sets.append((x,) + tuple(o.bfloat16() if o is not None and o.dim() > 1 else o
                                         for o in ops))
            reps = 4 * n_sets
            block = ResBlock(cin, co, k2.KERNEL_CI, 3, 1, False, 1e-5).to(dev).eval()
            randomize_bn(block, SEED)
            ms = cold_ms(lambda x, *o: fused_bottleneck(x, *o, tk=3), sets, reps)
            plain_ms = cold_ms(lambda x, *o: fused_bottleneck_reference(x, *o, tk=3), sets, reps)
            unfused_ms = cold_ms(lambda x, *o: block(x), sets, reps)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
            timings[(B, name)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                                      bytes_ms=t_bytes, ops_ms=t_ops, library_ms=None,
                                      unfused_ms=unfused_ms)
            emit({"phase": "k2_time", "block": name, "B": B, "T": T, "H": H, "W": W, "Cin": cin,
                  "Co": co, "tk": 3, "projection": project, "dtype": "bfloat16",
                  "kernel": k2.KERNELS[torch.bfloat16], "bytes": nbytes, "flops": flops,
                  **timings[(B, name)], "tflops": flops / ms * 1e-9,
                  "bf16_peak_share": flops / ms * 1e3 / PEAK_BF16_FLOPS,
                  "faster_than_unfused": ms < unfused_ms, "l2": "cold", "input_sets": n_sets,
                  "library": None, "library_note": "no single PyTorch call computes a whole "
                  "bottleneck", "unfused": "the port's ResBlock (cuDNN F.conv3d)"})
            del sets, block
    return timings


# -- phase 11: the fused-s2 scorer from a checkpoint ----------------------------

def phase_fused_scorer(dev, scorer, ckpt_dir: str):
    """Serve the checkpoint of ``scorer``'s weights (random init with random
    BN, written by the port's ``save_checkpoint``) with ``fused_s2``; →
    the bf16 fused scorer."""
    path = save_checkpoint(ckpt_dir, "i3d", 1, i3d_torch_to_flax(scorer.model.state_dict()),
                           metadata={"crop_size": 224, "clip_size": 32, "temporal_only": False,
                                     "epoch": 1})
    return serve_fused(dev, path, scorer.model, "fused_scorer", FUSED_TOLS, SPREAD_MIN)


def serve_fused(dev, path: str, unfused16_model, phase: str, tols: dict, spread_min: float):
    """The checkpoint at ``path`` served by ``from_jax_checkpoint`` with
    ``I3DConfig(fused_s2=True)`` in bf16 and float32 and unfused (the
    sidecar's geometry) in float32, on ring windows at B = 1 and 2: K2
    against its plain version through the float32 scorer, fused against
    unfused, bf16 against float32 (``tols``), K2's launches in one
    forward (3: s2's blocks), and the I3D forward time fused beside
    ``unfused16_model``'s; → the bf16 fused scorer."""
    kw = dict(upload_format="yuv420", device=dev)
    fused = I3DConfig(fused_s2=True)
    f16 = ClipScorer.from_jax_checkpoint(path, cfg=fused, **kw)
    f32 = ClipScorer.from_jax_checkpoint(path, cfg=fused, dtype=torch.float32, **kw)
    u32 = ClipScorer.from_jax_checkpoint(path, dtype=torch.float32, **kw)   # sidecar cfg: unfused
    if f16.cfg.fused_s2 is not True or u32.cfg.fused_s2 or u32.cfg.crop_size != 224:
        raise AssertionError("from_jax_checkpoint did not take the asked or the sidecar geometry")
    rng = np.random.RandomState(SEED + 5)
    T, S = 32, 256
    for B in (1, 2):
        ws = [torch.from_numpy(w).to(dev) for w in clip_windows(rng, B, T, S)]
        geo = [clip_geometry(rng, T) for _ in range(B)]
        boxes, lm5, scale = (torch.from_numpy(np.stack([g[i] for g in geo])).to(dev)
                             for i in range(3))
        crops = torch.stack(ws)
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        out = {}
        with torch.inference_mode():
            for key, sc, bott in (("k32", f32, fused_bottleneck),
                                  ("p32", f32, fused_bottleneck_reference),
                                  ("u32", u32, fused_bottleneck),
                                  ("k16", f16, fused_bottleneck)):
                launches = fused_bottleneck.launches
                p, logits, feats = sc._score_impl(crops, boxes, lm5, valid, scale=scale,
                                                  bottleneck=bott, with_features=True)
                out[key] = (p.double().cpu(), logits[:, 0].double().cpu(), feats.double().cpu(),
                            fused_bottleneck.launches - launches)
        p32, l32, f32_ = out["k32"][:3]
        r = {"phase": phase, "B": B, "probs_bf16": out["k16"][0].tolist(),
             "probs_f32": p32.tolist(), "probs_unfused_f32": out["u32"][0].tolist(),
             "k2_launches_per_forward": out["k16"][3],
             "kernel_vs_plain_k2_f32_dp": float((out["p32"][0] - p32).abs().max()),
             "fused_vs_unfused_f32_dp": float((out["u32"][0] - p32).abs().max()),
             "bf16_vs_f32_dp": float((out["k16"][0] - p32).abs().max())}
        if B >= 2:
            apart = float((f32_[0] - f32_[1]).norm())
            d32 = float(l32[0] - l32[1])
            d16 = float(out["k16"][1][0] - out["k16"][1][1])
            r.update({"f32_prob_spread": float(abs(p32[0] - p32[1])),
                      "f32_feature_distance": apart,
                      "kernel_vs_plain_k2_feature_rel":
                          float((out["p32"][2] - f32_).norm(dim=1).max()) / apart,
                      "bf16_vs_f32_feature_rel": float((out["k16"][2] - f32_).norm(dim=1).max())
                          / apart,
                      "bf16_vs_f32_logit_gap_rel": abs(d16 - d32) / abs(d32)})
        with torch.inference_mode():
            x = (f16._align_batch(yuv420_to_rgb(crops), boxes, lm5, scale) - f16._mean) / f16._std
            r["i3d_forward_ms_fused"] = event_ms(lambda: f16.model(x), 20)
            r["i3d_forward_ms_unfused"] = event_ms(lambda: unfused16_model(x), 20)
        r["dtype_forward"] = "bfloat16"
        r["tol"] = tols
        emit(r)
        p16 = np.array(r["probs_bf16"])
        if not (np.isfinite(p16).all() and ((p16 > 0) & (p16 < 1)).all()):
            raise AssertionError(f"{phase} B={B}: probs {p16} not finite in (0, 1)")
        if r["k2_launches_per_forward"] != 3 or out["k32"][3] != 3:
            raise AssertionError(f"{phase} B={B}: K2 launched {r['k2_launches_per_forward']} / "
                                 f"{out['k32'][3]} times in a forward (want 3)")
        for key, tol in tols.items():
            if key in r and not r[key] <= tol:
                raise AssertionError(f"{phase} B={B}: {key} {r[key]} > {tol}")
        if "f32_prob_spread" in r and not r["f32_prob_spread"] >= spread_min:
            raise AssertionError(f"{phase} B={B}: clips of different content give probs "
                                 f"only {r['f32_prob_spread']} apart (< {spread_min})")
    del f32, u32
    return f16


# -- phase 12: dense windows of one track through the fused scorer --------------

def phase_dense(fused16, unfused16, smi) -> int:
    """Every stride-1 window of one 300-frame track at batch 8, as the
    offline demo scores a whole track (``stdd_tpu/eval/demo.py:121,188``)."""
    T, S, N, batch = 32, 256, 300, 8
    rng = np.random.RandomState(SEED + 6)
    entries = []
    for i in range(N):
        crop = rng.randint(0, 255, (300, 280, 3), np.uint8)      # one pack scale < 1
        box = np.array([40.0 + i, 30.0, 320.0 + i, 330.0], np.float32)
        lm5 = (STD_POINTS_256 * (200.0 / 256.0) + np.array([40.0, 60.0]) + 0.05 * i
               + rng.uniform(-1, 1, (5, 2))).astype(np.float32)
        entries.append(_FrameEntry(crop, box, lm5))
    frames, boxes, lm5 = pack_track(entries, S, yuv420=True)
    starts = np.arange(N - T + 1)
    forwards = -(-len(starts) // batch)
    for sc in (fused16, unfused16):                            # warm-up at this batch
        sc.score_dense(frames, boxes, lm5, starts[:batch], batch=batch)
    torch.cuda.synchronize()
    fused_bottleneck.launches = warp_affine.launches = 0      # the K2 path's run starts here
    t0 = time.perf_counter()
    probs = fused16.score_dense(frames, boxes, lm5, starts, batch=batch)
    dt = time.perf_counter() - t0
    k2_launches, k1_launches = fused_bottleneck.launches, warp_affine.launches   # ... ends here
    t0 = time.perf_counter()
    probs_unfused = unfused16.score_dense(frames, boxes, lm5, starts, batch=batch)
    dt_unfused = time.perf_counter() - t0
    # the same windows gathered on the host and uploaded batch by batch
    packed = []
    for i in range(0, len(starts), batch):
        chunk = starts[i:i + batch]
        padded = np.zeros((batch,), np.int64)
        padded[:len(chunk)] = chunk
        idx = padded[:, None] + np.arange(T)
        valid = np.arange(batch) < len(chunk)
        packed.append(fused16.score(frames[idx], boxes[idx], lm5[idx], valid)[:len(chunk)])
    delta = float(np.abs(probs - np.concatenate(packed)).max())
    emit({"phase": "dense", "card": smi, "track_frames": N, "clip": T, "stride": 1,
          "windows": len(starts), "batch": batch, "forwards": forwards,
          "k2_launches": k2_launches, "k1_launches": k1_launches, "seconds": dt,
          "windows_per_s": len(starts) / dt, "seconds_unfused": dt_unfused,
          "windows_per_s_unfused": len(starts) / dt_unfused,
          "probs_min_max": [float(probs.min()), float(probs.max())],
          "fused_vs_unfused_bf16_dp": float(np.abs(probs - probs_unfused).max()),
          "dense_vs_packed_dp": delta, "tol": DENSE_TOL})
    if not (np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()):
        raise AssertionError(f"dense probs not finite in (0, 1): {probs}")
    if k2_launches != 3 * forwards or k1_launches != forwards:
        raise AssertionError(f"dense: K2 launches {k2_launches} (want {3 * forwards}), "
                             f"K1 launches {k1_launches} (want {forwards})")
    if not delta <= DENSE_TOL:
        raise AssertionError(f"dense vs host-packed |Δp| {delta} > {DENSE_TOL}")
    return k2_launches


# -- phase 13: I3D AltFreezing training, then its checkpoint served through K2 ----

TRAIN_VIDEOS, TRAIN_TRACKS, TRAIN_CLIPS = 6, 2, 3    # per class; per video; per track
TRAIN_T, TRAIN_S = 32, 224                            # the trainer's clip and crop
TRAIN_ARGS = ["--batch", "8", "--alter_freq", "2", "--precise_bn_batches", "2",
              "--base_lr", "0.01", "--warmup_epochs", "0.5", "--val_ratio", "0.15"]
TRAIN_TIMED_STEPS = 10
# a float32 step on the card against the same step on the CPU, TF32 off: the
# loss, the BN statistics and the parameters (one step at the warmup LR
# moves them by lr × the clipped gradient) within 1e-5 · max(1, max |CPU|);
# the gradients' norm and the momentum trace (the clipped gradient) within
# 1e-2 of theirs: float32 rounding in the 50-layer train-mode backward
# reaches 1.9e-3 of the largest gradient between the port's own float32 and
# float64 on the CPU at this geometry (scripts/torch_train_precision.py);
# an H100 measured 3.0e-5 and 4.2e-3
TRAIN_F32_TOLS = {"loss": 1e-5, "batch_stats": 1e-5, "params": 1e-5, "grad_norm": 1e-2,
                  "trace": 1e-2}
# the trained checkpoint served fused and unfused: FUSED_TOLS, but for the
# absolute |Δp| of bf16 against float32. Trained logits spread 30-40× wider
# than the random weights' (feature distance 97.6 against 3.0), so the same
# relative bf16 error (logit gap 0.12%, features 0.65%: within FUSED_TOLS)
# moves a prob near 0.6 by 8.2e-4 (measured on an H100); the bound is 3× that
TRAINED_TOLS = dict(FUSED_TOLS, bf16_vs_f32_dp=2.5e-3)


def synthetic_clip(rng, fake: bool, T: int, S: int) -> np.ndarray:
    """[T, S, S, 3] uint8: a smooth colour pattern drifting a pixel a frame;
    a fake carries the class cue, 40 grey levels brighter with per-pixel
    noise of σ 20 (which the training augmentations' jitter, blur and JPEG
    leave separable)."""
    base = np.kron(rng.uniform(50, 150, (8, 8, 3)), np.ones((S // 8 + 1, S // 8 + 1, 1)))
    clip = np.stack([np.roll(base, t, axis=1)[:S, :S] for t in range(T)])
    if fake:
        clip = clip + 40 + rng.normal(0, 20, clip.shape)
    return np.clip(clip, 0, 255).astype(np.uint8)


def write_clip_tree(root: str, rng) -> int:
    """``original/rNN`` and ``deepfakes/fNN`` videos of tracks of
    ``TRAIN_T``-frame clips (one training window each); → the number of
    clips."""
    n = 0
    for fake, prefix in ((False, "original/r"), (True, "deepfakes/f")):
        for v in range(TRAIN_VIDEOS):
            for t in range(TRAIN_TRACKS):
                for c in range(TRAIN_CLIPS):
                    d = os.path.join(root, f"{prefix}{v:02d}", f"track_{t}", f"clip_{c}")
                    os.makedirs(d)
                    np.save(os.path.join(d, "images.npy"),
                            synthetic_clip(rng, fake, TRAIN_T, TRAIN_S))
                    n += 1
    return n


def read_train_log(path: str):
    """The run's ``json_stats`` records and its ``STDD_TRAIN_TIMING`` splits
    (seconds of host data, upload+normalize, dispatch and block a step)."""
    stats, splits = [], []
    with open(path) as f:
        for line in f:
            if "json_stats: " in line:
                stats.append(json.loads(line.split("json_stats: ", 1)[1]))
            elif "timing iter " in line:
                words = line.split()
                i = words.index("data")
                splits.append([float(words[i + k].rstrip("s")) for k in (1, 3, 5, 7)])
    return stats, np.array(splits)


def train_f32_card_vs_cpu(dev) -> dict:
    """One float32 SGD step of the trainer on the card and on the CPU from
    the same weights and batch (8×64², batch 2)."""
    from stdd_torch.models.i3d import I3D
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training

    cfg = I3DConfig(num_frames=8, crop_size=64, dropout_rate=0.0)
    rng = np.random.RandomState(SEED + 8)
    x = torch.from_numpy(rng.randn(2, 8, 64, 64, 3).astype(np.float32))
    y = torch.tensor([0.0, 1.0])
    args = I3DTrainArgs(base_lr=0.01, max_epoch=1, warmup_epochs=0.5, warmup_start_lr=0.0025,
                        alter_freq=2, steps_per_epoch=4, grad_clip=1.0)
    out = {}
    for where in ("cpu", dev):
        model = I3D(cfg, dtype=torch.float32).to(where)
        state, step, _ = init_i3d_training(model, args)      # the same seed: the same weights
        randomize_bn(model, SEED)
        state, m = step(state, x.to(where), y.to(where), SEED)
        out[str(where)] = (float(m["loss"]), float(m["grad_norm"]),
                           {k: v.detach().double().cpu() for k, v in model.state_dict().items()},
                           {k: v.double().cpu() for k, v in state.opt_state[2]["trace"].items()})
    (lc, gc, sc, tc), (lg, gg, sg, tg) = out["cpu"], out[str(dev)]

    def err(a, b):
        return max(float((a[k] - b[k]).abs().max()) / max(1.0, float(b[k].abs().max()))
                   for k in b if b[k].is_floating_point())

    stats = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    params = [k for k in sc if k not in stats and sc[k].is_floating_point()]
    tmax = max(float(v.abs().max()) for v in tc.values())
    return {"loss": abs(lg - lc) / max(1.0, abs(lc)),
            "grad_norm": abs(gg - gc) / gc,
            "batch_stats": err({k: sg[k] for k in stats}, {k: sc[k] for k in stats}),
            "params": err({k: sg[k] for k in params}, {k: sc[k] for k in params}),
            "trace": max(float((tg[k] - tc[k]).abs().max()) for k in tc) / tmax,
            "loss_cpu": lc, "grad_norm_cpu": gc}


def device_busy(prof, steps: int):
    """The union of the profiled kernels' time intervals (ms; the device's
    busy time, whatever the streams), and the six kernels that took the most
    device time, in ms a step. (Summing ``self_device_time_total`` over
    ``key_averages()`` counts each kernel twice: as itself and under the op
    that launched it.)"""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return busy / 1000, {k[:90]: v / 1000 / steps for k, v in top}


def host_clip_times(tree: str, ds) -> dict:
    """Seconds of host work for one training clip on this machine's CPU
    (median of 3): loading it, the JPEG round trip and the 5×5 blur
    (``stdd_torch/data/degrade.py``), every augmentation at once, and a
    training item as the trainer draws it (the default probabilities)."""
    from stdd_torch.data.dataset_i3d import I3DClipDataset
    from stdd_torch.data.degrade import gaussian_blur, jpeg_recompress

    every = I3DClipDataset(root_dir=tree, T=TRAIN_T, is_train=True, seed=SEED, p_gauss_blur=1.0,
                           p_gauss_noise=1.0, p_jpeg=1.0, p_erase=1.0)
    clip = ds._stitch(ds.windows[0])

    def med(fn, n=3):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    return {"load": med(lambda: ds._stitch(ds.windows[0])),
            "jpeg_q80": med(lambda: jpeg_recompress(clip, 80)),
            "blur_k5": med(lambda: gaussian_blur(clip, 5)),
            "all_augmentations": med(lambda: every._augment(clip)),
            "train_item": med(lambda: [ds[i] for i in range(8)], 1) / 8}


def phase_train(dev, smi: str, tmp_dir: str):
    """``stdd_torch.train.run_i3d.main`` on the card at full width (I3D-R50,
    32×224², bf16 over float32 weights, batch 8): two epochs over both
    AltFreezing phases with precise-BN, validation and checkpoints, then a
    third epoch resumed from them; the step's device time on a fixed batch,
    the frozen group across a phase, precise-BN on the stem, a float32 step
    against the CPU's; → the path of the last checkpoint."""
    from stdd_torch.data.dataset_i3d import I3DClipDataset
    from stdd_torch.models.i3d import I3D, IMAGENET_MEAN, IMAGENET_STD
    from stdd_torch.train import run_i3d
    from stdd_torch.train.altfreeze import i3d_alt_labels
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training, precise_bn_update

    tree, out = os.path.join(tmp_dir, "clips"), os.path.join(tmp_dir, "train_run")
    n_clips = write_clip_tree(tree, np.random.RandomState(SEED + 7))   # set-up, not timed
    argv = ["--data", tree, "--out", out, "--clip_size", str(TRAIN_T), "--crop_size",
            str(TRAIN_S), *TRAIN_ARGS, "--device", str(dev)]
    os.environ["STDD_TRAIN_TIMING"] = "1"
    fused_bottleneck.launches = warp_affine.launches = 0        # the training path starts here
    t0 = time.perf_counter()
    state = run_i3d.main(argv + ["--epochs", "2"])
    seconds_2 = time.perf_counter() - t0
    k1, k2 = warp_affine.launches, fused_bottleneck.launches    # ... ends here
    steps_per_epoch = state.step // 2
    t0 = time.perf_counter()
    resumed = run_i3d.main(argv + ["--epochs", "3", "--resume"])
    seconds_resume = time.perf_counter() - t0
    del os.environ["STDD_TRAIN_TIMING"]
    stats, splits = read_train_log(os.path.join(out, "log.txt"))
    losses = [r["loss"] for r in stats if r["_type"] == "train_epoch"]
    aucs = [r["value"] for r in stats if r["_type"] == "val_epoch"]
    with open(os.path.join(out, "best.json")) as f:
        best = json.load(f)
    ckpt = os.path.join(out, "i3d_3.msgpack")

    # the step alone, on the card: the last checkpoint resumed in a fresh
    # model, one fixed batch already on the card
    model = I3D(I3DConfig(num_frames=TRAIN_T, crop_size=TRAIN_S), dtype=torch.bfloat16).to(dev)
    args = I3DTrainArgs(base_lr=0.01, max_epoch=3, warmup_epochs=0.5, warmup_start_lr=0.0025,
                        alter_freq=2, steps_per_epoch=steps_per_epoch, grad_clip=1.0)
    st, step, _ = init_i3d_training(model, args)
    st = run_i3d.load_train_checkpoint(ckpt, model, st)
    st.step = resumed.step
    ds = I3DClipDataset(root_dir=tree, T=TRAIN_T, is_train=True, seed=SEED)
    clips, ys = next(ds.batches(8, seed=SEED))
    mean, std = (torch.as_tensor(a, device=dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
    x = (torch.from_numpy(clips).to(dev).float() - mean) / std
    y = torch.from_numpy(ys).to(dev)
    for _ in range(2):                                          # warm-up
        st, m = step(st, x, y, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(TRAIN_TIMED_STEPS)]
    for a, b in evs:
        a.record()
        st, m = step(st, x, y, SEED)
        b.record()
    torch.cuda.synchronize()
    step_ms = np.array([a.elapsed_time(b) for a, b in evs])
    peak = torch.cuda.max_memory_allocated()
    # the device's busy time in three steps, from the profiler's kernel times
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            st, m = step(st, x, y, SEED)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1000
    busy_ms, top = device_busy(prof, steps=3)
    # across 2·alter_freq steps, each step's frozen group stays bit-identical
    labels = i3d_alt_labels(st.params)
    frozen_checked = 0
    for _ in range(4):
        group = "spatial" if (st.step // 2) % 2 == 0 else "temporal"
        keys = [k for k, v in labels.items() if v == group]
        before = [st.params[k].clone() for k in keys]
        st, m = step(st, x, y, SEED)
        if not all(torch.equal(st.params[k], b) for k, b in zip(keys, before)):
            raise AssertionError(f"train: a {group} parameter moved while frozen")
        frozen_checked += len(keys)
    stem = st.batch_stats["s1.pathway0_stem.bn.running_mean"]
    stem_before = stem.clone()
    precise_bn_update(model, st, [x, x.flip(0)])
    stem_moved = float((stem - stem_before).abs().max())
    del model, st, x
    torch.cuda.empty_cache()
    f32 = train_f32_card_vs_cpu(dev)
    host = host_clip_times(tree, ds)

    r = {"phase": "train", "card": smi, "model": "I3D-R50", "clip": TRAIN_T, "crop": TRAIN_S,
         "batch": 8, "dtype": "bfloat16 compute, float32 weights", "clips_written": n_clips,
         "steps_per_epoch": steps_per_epoch, "epoch_loss": losses, "val_auc": aucs,
         "best": {k: best[k] for k in ("best_epoch", "best_val_auc")},
         "seconds_two_epochs": seconds_2, "seconds_resumed_epoch": seconds_resume,
         "k1_launches": k1, "k2_launches": k2,
         "step_ms_median": float(np.median(step_ms)),
         "step_ms_p90": float(np.percentile(step_ms, 90)),
         "clips_per_s": 8 * 1000.0 / float(np.median(step_ms)),
         "host_split_s_median": dict(zip(("data", "upload_norm", "dispatch", "block"),
                                         np.median(splits, axis=0).tolist())),
         "host_data_s_max": float(splits[:, 0].max()),
         "max_memory_allocated_gib": peak / 2 ** 30,
         "profiled_steps": 3, "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
         "device_idle_share": (1 - busy_ms / prof_wall_ms) if busy_ms > 0 else None,
         "top_kernels_ms_per_step": top,
         "host_s_per_clip": host,
         "frozen_params_checked": frozen_checked, "precise_bn_stem_mean_moved": stem_moved,
         "f32_card_vs_cpu": f32, "tol": TRAIN_F32_TOLS}
    emit(r)
    if not (len(losses) == 3 and np.isfinite(losses).all() and min(losses[1:]) < losses[0]):
        raise AssertionError(f"train: epoch losses {losses} not finite or not falling")
    if not (len(aucs) == 3 and all(0.0 <= a <= 1.0 for a in aucs)):
        raise AssertionError(f"train: validation AUCs {aucs} not in [0, 1]")
    for name in ("i3d_1.msgpack", "i3d_2.msgpack", "i3d_3.msgpack", "i3d_3.msgpack.json",
                 "best.json"):
        if not os.path.isfile(os.path.join(out, name)):
            raise AssertionError(f"train: {name} was not written")
    if resumed.step != 3 * steps_per_epoch or resumed.opt_state[-1]["count"] != resumed.step:
        raise AssertionError(f"train: the resumed run ended at step {resumed.step}, count "
                             f"{resumed.opt_state[-1]['count']} (want {3 * steps_per_epoch})")
    if k1 or k2:
        raise AssertionError(f"train: K1/K2 launched {k1}/{k2} times on the training path")
    if not stem_moved > 0:
        raise AssertionError("train: precise-BN left the stem's statistics where they were")
    for key, tol in TRAIN_F32_TOLS.items():
        if not f32[key] <= tol:
            raise AssertionError(f"train: float32 card vs CPU {key} {f32[key]} > {tol}")
    return ckpt


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # float32 without TF32, as the app runs the detector
    # (stdd_torch/runtime/app.py main); the scorer's float32 checks too
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # one nvcc for each kernel source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = {"warp_affine": pool.submit(timed, build_kernel),
                "fused_bottleneck": pool.submit(timed, k2.build_kernel)}
        build_s = {k: f.result() for k, f in futs.items()}
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = native_available()
    rec = {"phase": "build", "kernels_wall_s": t_kernels, "native_s": time.perf_counter() - t0,
           "native": native}
    for k in ("warp_affine", "fused_bottleneck"):
        info = build_info[k]
        rec.update({f"{k}_s": build_s[k], f"{k}_library": info["library"],
                    f"{k}_reused": info["reused"],
                    f"{k}_ptxas": info["ptxas"].strip().splitlines()})
    emit(rec)

    k1_err, k1_timings = phase_k1(dev)
    k2_err = phase_k2_check(dev)
    k2_timings = phase_k2_time(dev)
    scorer = phase_scorer(dev)
    scene = Scene((1080, 1920), n_faces=1, seed=SEED)
    # rendered before any clock starts: making data is set-up
    frames = [scene.frame(i) for i in range(ENGINE_WARM + ENGINE_FRAMES)]
    engine_res, n_main = phase_engine(scorer, smi, scene, frames)
    k1_launches = engine_res["k1_launches"]
    with tempfile.TemporaryDirectory() as tmp_dir:
        det = phase_detector(dev, tmp_dir, smi)
        phase_engine_detector(scorer, det, smi, scene, frames, engine_res)
        phase_server(scorer, smi)
        phase_app(scorer, det, smi, scene, frames)
        del frames, det
        fused16 = phase_fused_scorer(dev, scorer, tmp_dir)
    k2_launches = phase_dense(fused16, scorer, smi)
    del fused16
    with tempfile.TemporaryDirectory() as tmp_dir:
        ckpt = phase_train(dev, smi, tmp_dir)
        trained16 = ClipScorer.from_jax_checkpoint(ckpt, upload_format="yuv420", device=dev)
        serve_fused(dev, ckpt, trained16.model, "train_served", TRAINED_TOLS, 0.0)
        del trained16

    # each kernel's numbers at the shape its path launched it with: K1 at
    # the engine's N; K2 at score_dense's batch of 8 clips, per launch over
    # one forward's three launches (block 0, then blocks 1 and 2)
    t1 = k1_timings[n_main]
    b0, b1 = k2_timings[(8, "block0")], k2_timings[(8, "block1")]
    per_launch = {k: (b0[k] + 2 * b1[k]) / 3 for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    k2_bound_by = "bytes" if per_launch["bytes_ms"] >= per_launch["ops_ms"] else "operations"
    emit({"kernels": [
        {"name": "warp_affine", "route": "cuda", "source": "stdd_torch/csrc/warp_affine.cu",
         "replaces": "stdd_tpu/ops/warp_pallas.py:94", "launches": k1_launches,
         "max_abs_err": k1_err, "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"], "library_ms": t1["library_ms"]},
        {"name": "fused_bottleneck", "route": "cuda",
         "source": "stdd_torch/csrc/fused_bottleneck.cu",
         "replaces": "stdd_tpu/ops/bottleneck_pallas.py:148", "launches": k2_launches,
         "max_abs_err": k2_err, "ms": per_launch["ms"], "plain_ms": per_launch["plain_ms"],
         "bound_ms": max(per_launch["bytes_ms"], per_launch["ops_ms"]), "bound_by": k2_bound_by,
         "library_ms": None}]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
