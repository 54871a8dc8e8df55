#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stdd_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (any failed check raises, and the script then
exits non-zero without its result line):

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — K1 (``stdd_torch/csrc/warp_affine.cu``), K2
              (``stdd_torch/csrc/fused_bottleneck.cu``) and K3
              (``stdd_torch/csrc/bias_act.cu``) with nvcc for sm_90a,
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
10b. K3     — BN's shift, the residual and the ReLU in one pass
              (``stdd_torch/csrc/bias_act.cu``) against its plain PyTorch
              version, bit for bit, at the I3D's and FTCN-TT's passes at
              score_dense's batch of 8 and a ragged one, in bf16 and fp16;
              bf16 times with a cold L2 beside the byte bound, the plain
              version and today's unfused BN scale, shift, residual add and
              ReLU as PyTorch runs them (the library time);
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
              scorer's on the same track, and K3's launches on both runs
              (40 and 49 a forward; the unfused run is K3's main path);
13. train   — ``stdd_torch.train.run_i3d.main`` on the card at full width
              (I3D-R50, 32×224², bf16, batch 8) over a synthetic clip tree
              the script writes: two epochs over both AltFreezing phases
              with precise-BN, validation and checkpoints, then a third
              resumed from them; the loss must fall, K1 and K2 stay
              unlaunched (K3 runs in validation only); then on the last checkpoint the step's device
              time (CUDA events) and the profiler's busy share, peak
              memory, a frozen group across a phase, precise-BN on the
              stem, the host's cost per clip, and a float32 step on the
              card against the CPU's (``TRAIN_F32_TOLS``);
14. train_served — the trained checkpoint served unfused and through K2
              (3 launches a forward), as the fused scorer phase does, within
              ``TRAINED_TOLS``;
15. dual    — ``stdd_torch.train.run_dual.main`` on the card at the shipped
              run's width (d_model 256, 4 layers, 4 heads, T 8, batch 256,
              DAT, SLERP, one-cycle AdamW) over a synthetic feature tree the
              script writes (a real class and four fake techniques): three
              epochs, validation, temperature, ``best.msgpack`` and the test
              report; the loss must be finite, ``best.msgpack`` must reload
              to the same logits, K1 and K2 stay unlaunched; the step's
              device time on a fixed batch (CUDA events), peak memory, the
              profiler's busy share, and the host's ``load_all``;
16. dual_f32 — one float32 step of the dual trainer on the card against
              the same step on the CPU (dropout 0, the same SLERP draws),
              within ``DUAL_F32_TOLS``;
17. landmarker — the packaged dense landmarker (``LandmarkNet``, width 32)
              on 16 faces rendered on the card from seeded parameters: the
              same net on the CPU (``LANDMARK_TOLS``), the key-landmark
              error against the renderer's mesh (< 0.01 crop-normalized),
              faces/s at batch 1 and 16 and of the whole per-face call;
18. au      — the AU ResNet-18 at 224² on random weights bridged through
              the flax tree, on the card against the CPU (``AU_TOL``);
              faces/s at batch 4 and 16;
19. preprocess — ``PreprocessPipeline.process_video`` over 64 frames of a
              1080p ``BenchScene`` with 4 faces (a .y4m written before the
              clock starts), with the packaged landmarker, the AU model and
              ``detect_scaled`` on the YuNet-shaped random graph for its
              device cost returning the scene's oracle rows
              (``"detections_real": false``): 4 unflagged tracks, 60 clips,
              landmarks within ``PRE_PX_TOL`` of the mesh, the tree turned
              into features, loaded by ``DualFeaturesClipDataset`` and
              scored by the dual model; frames/s and the stage times; K1/K2
              unlaunched; then the CLI ``main`` over the same file;
20. landmarker_train — ``train_landmarker.train`` at the shipped batch of
              256 for 60 steps: the loss must fall; the step's device time,
              peak memory, the profiler's busy share and ``holdout_error``.
21. reference_ckpt — the scorer's weights (an RGB-upload scorer over the
              main scorer's, 32×224² bf16) written as a reference-format
              ``.pth`` and served by ``ClipScorer.from_torch_checkpoint``: the
              same weights and probs (``REFERENCE_CKPT_TOL``);
22. harness — ``stdd_torch.eval.harness``'s ``run_video`` → ``summarize``
              → ``write_csvs`` over four 720p ``BenchScene`` videos (real/,
              fake/; 96 frames, one face) at the JAX CLI's defaults (clip 32,
              stride 5, detect every 4, batch 8), the scene's oracle as the
              detector (``"detections_real": false``): 96 frames and one
              track a video, scores in (0, 1), the CSV headers, K1 launches
              equal to the scored batches; fps, latency, peak memory,
              windows/s; then the CLI in its own process over a list file
              with ``--ckpt`` = that ``.pth`` and YuNet on the random graph;
23. demo    — ``stdd_torch.eval.demo.eval_video`` on the first video with
              the oracle's detections in the cache layout: dense, then the
              packed path over the same 65 windows at batch 8: the same
              windows, ``dense_vs_packed_dp`` within ``DENSE_TOL``, one K1
              launch a forward; the wall time of phases 21-23;
24. capstone — ``stdd_torch.eval.synth_e2e.main --dual`` at full width
              (720p, clip 32, crop 224, the I3D-R50 trained and served in
              bf16, the dual encoder's shipped width) and reduced depth
              (``CAPSTONE_ARGS``): render → preprocess (oracle detections)
              → run_i3d → the harness → run_dual; JAX's capstone contract
              (eval videos, checkpoint epoch, AUCs in [0, 1], the five
              phases, landmarked clips, ``detections_real`` false), no
              ``dual_error``, K1 launches = the harness's warm-up + its
              scored batches, K2 none; each phase's wall and disk bytes;
25. fusion  — on the capstone's outputs: ``dump_video_features`` over its
              eval videos with its served checkpoint (K1 a scored batch),
              ``load_feature_clips``, one float32 AdamW step of
              ``DualEncoderRGB`` at full width, batch 256, card vs CPU
              (``FUSION_TOLS``; no gradient reaches ``rgb_proj`` or the
              features) with its device time and kernels; ``align_scores``
              of the harness's CSV (keys made unique) with the dual model's
              per-video scores and ``train_moe`` card vs CPU (``MOE_TOL``);
              ``pretrain_lmk`` on 2,048 synthetic landmark sequences, whose
              loss must fall and last accuracy pass 0.5, and its step time;
26. app_file — the app over a ``.y4m`` file: a 720p ``BenchScene`` with
              one face, 120 frames (~166 MB, written before any clock
              starts); ``RealtimeApp`` + ``run_loop`` over
              ``sources.iter_video_file`` at ``app``'s operating point with
              the scene's oracle rows: fps with the decode, K1 launches
              equal to the dispatched batches and above 0; the same app over
              the same decoded frames in memory gives the same probabilities
              (``APP_FILE_TOL``); then ``python -m stdd_torch.runtime.app
              --source FILE --max_frames 48`` in its own process on the
              YuNet-shaped random graph exits 0 having seen 48 frames (no
              track starts on random weights);
27. regen   — ``DualVideoRegenDataset`` (T 8, stride 2, training draws,
              ``ClipDegrader`` at its defaults) over four 720p videos
              (``original/`` ×2, ``deepfakes/`` ×2, one face, 48 frames) with
              the packaged landmarker at the scene's boxes and the AU
              ResNet-18 (random weights) on the card: ``load_all``, the
              seconds an item spends in decode, degrade, landmarker and AU,
              each degradation's ms on a 720p frame; item 0 on the card
              against the CPU models (``L`` within a bound derived from
              ``LANDMARK_TOLS``, ``A`` within ``AU_TOL``); one float32 step of
              the dual trainer on the arrays; K1/K2 unlaunched;
28. vox     — ``build_index`` and ``VoxLmkDataset(T=32, is_train=True)
              .batches(64)`` over a speaker tree of ``lmk_features.npy``
              (regen's rows and synthetic sequences, 17 speakers), then
              ``pretrain_lmk`` for one epoch on the card: step ms, loss;
29. libreface — a rendered face frame written as PNG (``image_io``),
              ``get_aligned_image`` with the scene's box standing in for
              YuNet and the packaged landmarker on the card, ``image_align``
              and the AU ResNet-18 on the crop, ``main`` end to end; the ms
              of each step, the landmarks against the renderer's mesh
              (``PRE_PX_TOL``), K1/K2 unlaunched.

30. overlay — the app with the overlay over a 720p ``BenchScene`` ``.y4m``
              of one face (120 frames, oracle rows) at ``app``'s point:
              fps without and with the overlay (``run_loop`` with
              ``out_video`` and ``on_frame``), the overlay's ms a frame, K1
              launches equal to the dispatched batches, the written file
              decoded against the ``.y4m`` round trip of the in-memory
              overlays (0 difference), the boxes drawn; then ``python -m
              stdd_torch.runtime.app --source FILE --out_video O.y4m`` over
              32 frames on the YuNet-shaped random graph exits 0 and writes
              them;
31. viz     — ``visualize_detections``, ByteTracker + ``visualize_tracks``
              and the packaged landmarker on the card + ``draw_dense_landmarks``
              over 24 of those frames and their oracle rows: ms a frame of
              each and the landmarker's share; then ``python -m
              stdd_torch.eval.viz`` on a ``.y4m`` (``--track
              --dense_landmarks``) and on a PNG against the random graph
              (``"detections_real": false``);
32. tile    — ``LargestTilePicker.pick`` (host numpy) on four rendered 1080p
              2×2 call grids (``BenchScene`` tiles, 4-px gutters) and on two
              frames with no tile: the picks against the tiles drawn (most
              must be one, IoU ≥ ``TILE_IOU``), the whole frame with no
              motion reference, the motion fallback after; ms a frame;
33. multigrid — ``stdd_torch.train.measure_multigrid --steps_per_epoch 2``:
              ``MultigridConfig()`` at I3D-R50 32×224² bf16 through its four
              long-cycle shapes (45 epochs), the step rebuilt at each, a
              bitwise checkpoint restore mid-schedule, precise-BN, a finite
              loss and the held-out AUC; ms a step and peak memory a shape;
34. geo_jitter — ``I3DClipDataset`` items at ``geo_jitter`` 1.0 and 0 on a
              32×224² clip tree (host seconds an item), and one
              ``run_i3d``-shaped step (bf16, batch 8) on jittered clips.
              K1 and K2 stay unlaunched in 31-34.
35. ftcn_train — ``stdd_torch.train.run_i3d.main`` with ``--ftcn`` on the
              train phase's synthetic tree at full width (FTCN, stop_point
              5, 32×224², bf16, batch 8) for one epoch: a finite loss, the
              sidecar's ``temporal_only: true``, the step's device time and
              peak memory on a fixed batch, and a float32 step on the card
              against the CPU's (``TRAIN_F32_TOLS``, the I3D's);
36. ftcn_serve — a temporal-only I3D-R50 checkpoint (random weights, its
              ``temporal_only`` sidecar) served by ``ClipScorer`` at 32×224²
              bf16 with ``fused_s2`` on over I420 ring windows: K1 once a
              batch, K2 never, ms a batch, float32 probs on the card
              against the CPU (``FTCN_SERVE_TOL``), and the ``--ftcn``
              checkpoint refused as JAX's loader refuses it;
37. zoo     — every ``build_model`` name at its published width: one bf16
              eval forward (ms, peak memory; the transformers under
              autocast) and a float32 forward at a small input on the card
              against the CPU (``ZOO_F32_TOL``); RetinaFace and SCRFD (a
              random graph of its layout) on one rendered 720p
              ``BenchScene`` frame, random weights (``"detections_real":
              false``). K1 and K2 stay unlaunched in 35 and 37.
38. ddp     — ``run_i3d --mesh`` on the one card (world 1 over NCCL) beside
              the plain ``run_i3d``, one epoch each of the train phase's
              tree at full width (I3D-R50, 32×224², bf16, batch 8): the
              epoch losses within ``DDP_LOSS_TOL``, the mesh checkpoint
              resumed by the plain trainer, the step's device time plain
              and mesh in turns; then two ranks on the card over gloo carrying CUDA
              tensors (NCCL refuses two ranks on one device): a float32
              I3D step at world 2 against world 1 (``DDP_WORLD_TOL``), and
              a dual step in float32 and in float64 at the shipped width with
              ``DualTrainArgs``' SLERP and DAT (an invalid ``dom_id``
              among the domains) at world 2 against world 1
              (``DDP_DUAL_TOLS``), each with the collectives it carried and
              its time; and ``dryrun_multichip(2, "cuda")``, the
              dry run's entry point, whose ranks pick gloo on the one card
              (K1 once a rank, the same gathered probs on both); K1 and K2
              unlaunched in training;
39. int8    — the int8 serving knob at full width (I3D-R50, 32×224²,
              bf16, I420): ms a batch with and without it at B = 2 and 8
              in turns, |Δp|, K1 once a batch and 42 integer GEMMs a
              forward; ``fused_s2`` + int8 (K2 3 a forward); float32 int8
              probs card vs CPU (8×64², ``INT8_F32_TOL``); one s4
              convolution's int32 accumulators bit-equal to the plain
              version, its time beside the bf16 cuDNN convolution; the app
              with the int8 scorer over 120 frames of a 720p scene.
40. slice16 — the scorer's reference-quantization mode
              (``round_aligned_u8``, ``score_index=0``) at full width
              (I3D-R50, 32×224², bf16 and float32, I420) at B = 2 and 8:
              the I3D's input integers in [0, 255], the float32 probs
              through K1 equal to those through the plain warp, bf16
              within ``TOLS``' bf16 bound, |Δp| against the unrounded
              scorer, K1 once a batch, ms a batch with and without the
              rounding in turns; one ``fused_s2`` batch with it (K2 3, K1
              1); a two-class head scored on ``score_index=1``, float32,
              card against CPU (8×64²).

The K2 and K3 phases (10, 10b) run before the scorer (4) in the script,
as the K2 phases did,
the evaluation phases (21-25) before training (13), and phases 26-29, then
30-34, then 35-37, then 38-39, then 40, last.
Every measurement is printed as one JSON object per line; then the
``{"kernels": [...]}`` line (with each kernel's launches on every path that
counted them, each from zero at the path's start; K3's checked at 49 a
bf16 I3D forward on the engine, server, app, dense and demo paths, at its
fused_s2 and int8 counts there, and at 0 in training steps), the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX or stdd_tpu.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import json
import logging
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
from stdd_torch.ops import bias_act as k3  # noqa: E402
from stdd_torch.ops import bottleneck as k2  # noqa: E402
from stdd_torch.ops.align import STD_POINTS_256  # noqa: E402
from stdd_torch.ops.bottleneck import fused_bottleneck, fused_bottleneck_reference  # noqa: E402
from stdd_torch.ops.warp import build_kernel, warp_affine, warp_affine_reference  # noqa: E402
from stdd_torch.runtime.classifier import ClipScorer, yuv420_to_rgb  # noqa: E402
from stdd_torch.models.yunet import YuNet, detect_scaled, resize_linear_u8  # noqa: E402
from stdd_torch.ops.nms import nms_fixed  # noqa: E402
from stdd_torch.runtime.app import RealtimeApp, run_loop  # noqa: E402
from stdd_torch.runtime.engine import (AsyncDetector, StreamingEngine, _FrameEntry,  # noqa: E402
                                       get_crop_box)
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
            final = name.endswith(("branch2.c.bn", ".c.Conv3dBN_0.bn"))
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


def engine_numbers(eng, scored, dt, n_frames, launches, batches, k3_launches) -> dict:
    """fps, window latency and K1 and K3 launches of one timed engine or
    server run of the bf16 I3D scorer."""
    probs = np.array([p for _, p in scored], np.float64)
    lats = 1000.0 * np.asarray(eng.clip_latencies, np.float64)
    if not scored:
        raise AssertionError("no clip was scored")
    if not np.isfinite(probs).all():
        raise AssertionError(f"non-finite scores: {probs}")
    if launches == 0 or launches != batches:
        raise AssertionError(f"K1 launches {launches} != dispatched batches {batches}")
    if k3_launches != K3_PER_FORWARD["i3d"] * batches:
        raise AssertionError(f"K3 launches {k3_launches} != {K3_PER_FORWARD['i3d']} × "
                             f"dispatched batches {batches}")
    return {"frames": n_frames, "fps": n_frames / dt, "clips_scored": len(scored),
            "batches_dispatched": batches, "k1_launches": launches,
            "k1_launches_per_batch": launches / batches, "k3_launches": k3_launches,
            "k3_launches_per_batch": k3_launches / batches,
            "window_latency_p50_ms": float(np.percentile(lats, 50)) if lats.size else None,
            "window_latency_p95_ms": float(np.percentile(lats, 95)) if lats.size else None}


def drive_engine(scorer, frames, detect_fn, path: str) -> dict:
    """The live path at the bench's operating point (``bench.py:215-263``):
    warm-up, then ``ENGINE_FRAMES`` timed frames with K1's and K3's counts
    zeroed just before and read just after (K3's kept under ``path``)."""
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
        warp_affine.launches = k3.bias_act.launches = 0  # the path's run starts here
        scored = []
        t0 = time.perf_counter()
        for i in range(ENGINE_WARM, ENGINE_WARM + ENGINE_FRAMES):
            scored += eng.step(frames[i])
        scored += eng.flush()
        dt = time.perf_counter() - t0
        launches, k3n = warp_affine.launches, k3_read(path)   # ... and ends here
        batches = eng._group._next_seq - seq0
    finally:
        eng.close()
    res = engine_numbers(eng, scored, dt, ENGINE_FRAMES, launches, batches, k3n)
    res["tracks"] = len(eng.track_clip_scores)
    return res


def phase_engine(scorer, smi, scene, frames):
    pipe = PipelineConfig(**ENGINE_PIPE)
    res = {"phase": "engine", "card": smi, "detector": "scene oracle",
           **drive_engine(scorer, frames, scene.oracle(pipe.detect_every), "engine")}
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
                                                       spans), "engine_detector")
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
        warp_affine.launches = k3.bias_act.launches = 0  # the server's run starts here
        t0 = time.perf_counter()
        for i in range(SERVER_FRAMES):
            for k, sid in enumerate(sids):
                got[sid] += server.step(sid, frames[k][i])
        for sid in sids:
            got[sid] += server.flush(sid)
        dt = time.perf_counter() - t0
        launches = warp_affine.launches                # ... and ends here
        k3n = k3_read(f"server_{n}calls_{wait}")
        batches = group._next_seq - seq0
        scored = [x for sid in sids for x in got[sid]]
        res = {"phase": "server", "card": smi, "streams": n,
               "max_batch_wait_frames": wait,
               **engine_numbers(server._root, scored, dt, n * SERVER_FRAMES, launches,
                                batches, k3n)}
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
        warp_affine.launches = k3.bias_act.launches = 0  # the app's run starts here
        t0 = time.perf_counter()
        ready, fake = run_loop(app, iter(frames[:APP_FRAMES]))
        dt = time.perf_counter() - t0
        launches, k3n = warp_affine.launches, k3_read("app")   # ... and ends here
        batches = eng._group._next_seq - seq0
    finally:
        eng.close()
    scores = {int(t): [float(p) for p in s] for t, s in app.running_scores.items()}
    res = {"phase": "app", "card": smi, "detections_real": False, "frames": APP_FRAMES,
           "fps": APP_FRAMES / dt, "meeting_ready": bool(ready), "meeting_fake": bool(fake),
           "scored_tracks": scores, "k1_launches": launches, "batches_dispatched": batches,
           "k3_launches": k3n, "frames_seen": app.frames_seen}
    emit(res)
    flat = [p for s in scores.values() for p in s]
    if not (ready and flat and np.isfinite(flat).all() and launches == batches > 0
            and k3n == K3_PER_FORWARD["i3d"] * batches):
        raise AssertionError(f"app: ready {ready}, scores {scores}, K1 launches {launches}, "
                             f"K3 launches {k3n}, batches {batches}")
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


# -- phase 10b: K3 ---------------------------------------------------------------

# (name, y shape [B, C, T, H, W], residual, relu): the I3D's and FTCN-TT's
# passes at score_dense's batch of 8 (the stem; s2's last convolution with
# its residual, the table's row; s5's; FTCN-TT's s4 stride-pooled
# shortcut), and a ragged one (C = 24: 3 vectors of 8 channels)
K3_CASES = (("i3d_stem", (8, 64, 32, 112, 112), False, True),
            ("i3d_s2_last", (8, 256, 32, 56, 56), True, True),
            ("i3d_s5_last", (8, 2048, 16, 7, 7), True, True),
            ("ftcn_s3_b", (8, 128, 16, 28, 28), False, True),
            ("ragged_c24", (3, 24, 5, 7, 9), True, True))
K3_ROW = "i3d_s2_last"


def k3_operands(dev, shape, residual, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last_3d
    y = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype).contiguous(memory_format=cl)
    b = torch.randn(shape[1], generator=g, device=dev)
    r = (torch.randn(shape, generator=g, device=dev).to(dtype).contiguous(memory_format=cl)
         if residual else None)
    return y, b, r


def phase_k3(dev):
    """K3 against its plain version, bit for bit, at every case in bf16 and
    fp16; then, in bf16 with a cold L2, K3, its plain version and today's
    unfused BN (``x · inv + shift`` in the activation's dtype), residual add
    and ReLU as PyTorch runs them, beside the byte bound. → (max |Δ|,
    timings by case)."""
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float16):
        for i, (name, shape, residual, relu) in enumerate(K3_CASES):
            y, b, r = k3_operands(dev, shape, residual, dtype, SEED + 30 + i)
            want = k3.bias_act_reference(y.clone(), b, r, relu)
            n0 = k3.bias_act.launches
            got = k3.bias_act(y, b, r, relu)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            emit({"phase": "k3_check", "case": name, "shape": list(shape), "residual": residual,
                  "relu": relu, "dtype": str(dtype).replace("torch.", ""),
                  "bit_exact": bool(torch.equal(got, want)), "max_abs_err": err})
            if not torch.equal(got, want) or k3.bias_act.launches != n0 + 1:
                raise AssertionError(f"K3 {name}/{dtype}: not bit-exact (max |Δ| {err}) or "
                                     f"not launched once")
            max_err = max(max_err, err)
            del y, b, r, want, got
    timings = {}
    for i, (name, shape, residual, relu) in enumerate(K3_CASES[:-1]):
        numel = int(np.prod(shape))
        nbytes = numel * 2 * (3 if residual else 2) + shape[1] * 4
        n_sets = -(-4 * L2_BYTES // nbytes) + 1
        sets = []
        for k in range(n_sets):
            y, b, r = k3_operands(dev, shape, residual, torch.bfloat16, SEED + 40 + k)
            # today's BN, from a scale and shift that give the same y + b
            inv = torch.ones_like(b).bfloat16().view(-1, 1, 1, 1)
            sets.append((y, b, r, inv, b.bfloat16().view(-1, 1, 1, 1)))
        reps = 4 * n_sets

        def library(y, b, r, inv, shift):
            z = y * inv + shift
            return F.relu(z if r is None else r + z) if relu else (z if r is None else r + z)

        ms = cold_ms(lambda y, b, r, *_: k3.bias_act(y, b, r, relu), sets, reps)
        plain_ms = cold_ms(lambda y, b, r, *_: k3.bias_act_reference(y, b, r, relu), sets, reps)
        library_ms = cold_ms(library, sets, reps)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        timings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                             bound_by="bytes")
        emit({"phase": "k3_time", "case": name, "shape": list(shape), "residual": residual,
              "relu": relu, "dtype": "bfloat16", "bytes": nbytes, **timings[name],
              "roofline_share": bound_ms / ms, "achieved_tb_s": nbytes / ms * 1e-9,
              "l2": "cold", "input_sets": n_sets, "launches_per_round": reps,
              "library": "y * inv + shift, (r + ...), relu: today's unfused eval BN, "
                         "residual add and ReLU"})
        del sets
    return max_err, timings


# K3's launches on each path, counted from zero at the path's start (where
# K1's and K2's counts are zeroed) to its end; the kernels line reports them
k3_by_path = {}
# K3 passes in one bf16 eval forward: the I3D-R50's 16 blocks × 3 and its
# stem; with fused_s2, s2's 3 blocks run K2 instead; with int8 s3-s5, only
# the stem and s2 fold; with both, only the stem
K3_PER_FORWARD = {"i3d": 49, "fused_s2": 40, "int8": 10, "fused_s2_int8": 1}


def k3_read(path: str, n=None) -> int:
    """K3's launches since the path's start (or ``n``, the count a helper
    read at the path's end), kept under ``path``."""
    n = k3_by_path[path] = k3.bias_act.launches if n is None else n
    return n


def k3_entry(err, timings) -> dict:
    """The kernels line's K3 entry: its launches on the main path (the bf16
    I3D's dense scoring) and on every other path."""
    t = timings[K3_ROW]
    return {"name": "bias_act", "route": "cuda", "source": "stdd_torch/csrc/bias_act.cu",
            "replaces": None, "launches": k3_by_path["dense"],
            "launches_by_phase": dict(k3_by_path), "max_abs_err": err, "case": K3_ROW,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


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

def phase_dense(fused16, unfused16, smi):
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
    # the K2 path's run starts here
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    t0 = time.perf_counter()
    probs = fused16.score_dense(frames, boxes, lm5, starts, batch=batch)
    dt = time.perf_counter() - t0
    k2_launches, k1_launches = fused_bottleneck.launches, warp_affine.launches   # ... ends here
    k3_fused = k3_read("dense_fused_s2")
    k3.bias_act.launches = 0                            # the main path's run starts here
    t0 = time.perf_counter()
    probs_unfused = unfused16.score_dense(frames, boxes, lm5, starts, batch=batch)
    dt_unfused = time.perf_counter() - t0
    k3_dense = k3_read("dense")                           # ... and ends here
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
          "k2_launches": k2_launches, "k1_launches": k1_launches,
          "k3_launches_fused": k3_fused, "k3_launches_unfused": k3_dense, "seconds": dt,
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
    want3 = (K3_PER_FORWARD["fused_s2"] * forwards, K3_PER_FORWARD["i3d"] * forwards)
    if (k3_fused, k3_dense) != want3:
        raise AssertionError(f"dense: K3 launches {k3_fused} fused_s2 / {k3_dense} unfused "
                             f"(want {want3})")
    if not delta <= DENSE_TOL:
        raise AssertionError(f"dense vs host-packed |Δp| {delta} > {DENSE_TOL}")
    return k2_launches, k1_launches


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


def train_f32_card_vs_cpu(dev, ftcn: bool = False) -> dict:
    """One float32 SGD step of the trainer (the I3D-R50, or the FTCN with
    its head's dropout off) on the card and on the CPU from the same weights
    and batch (8×64², batch 2)."""
    from stdd_torch.models.ftcn import FTCN
    from stdd_torch.models.i3d import I3D
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training

    cfg = I3DConfig(num_frames=8, crop_size=64, dropout_rate=0.0, temporal_only=ftcn)
    rng = np.random.RandomState(SEED + 8)
    x = torch.from_numpy(rng.randn(2, 8, 64, 64, 3).astype(np.float32))
    y = torch.tensor([0.0, 1.0])
    args = I3DTrainArgs(base_lr=0.01, max_epoch=1, warmup_epochs=0.5, warmup_start_lr=0.0025,
                        alter_freq=2, steps_per_epoch=4, grad_clip=1.0)
    out = {}
    for where in ("cpu", dev):
        model = (FTCN if ftcn else I3D)(cfg, dtype=torch.float32).to(where)
        state, step, _ = init_i3d_training(model, args)      # the same seed: the same weights
        randomize_bn(model, SEED)
        if ftcn:
            model.head.dropout = 0.0
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
    # the training path starts here
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    t0 = time.perf_counter()
    state = run_i3d.main(argv + ["--epochs", "2"])
    seconds_2 = time.perf_counter() - t0
    k1, k2 = warp_affine.launches, fused_bottleneck.launches    # ... ends here
    k3_run = k3_read("train")                # its validation scores in bf16 eval: folded
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
    k3.bias_act.launches = 0                                    # the steps alone start here
    step_ms, peak, st = timed_steps(step, st, x, y, TRAIN_TIMED_STEPS)
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
    k3_steps = k3_read("train_steps")                           # ... and end here
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
         "k1_launches": k1, "k2_launches": k2, "k3_launches": k3_run,
         "k3_launches_steps": k3_steps,
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
    if k3_steps:
        raise AssertionError(f"train: K3 launched {k3_steps} times in training steps")
    if not stem_moved > 0:
        raise AssertionError("train: precise-BN left the stem's statistics where they were")
    for key, tol in TRAIN_F32_TOLS.items():
        if not f32[key] <= tol:
            raise AssertionError(f"train: float32 card vs CPU {key} {f32[key]} > {tol}")
    return ckpt


# -- phase 15: the dual encoder trained and evaluated on the card ------------------

# a synthetic clip-feature tree: per technique, videos of one track of 12-frame
# clips (the trainer crops 8); names unique per technique, so no two videos
# link. 3,072 clips: the training split (~2,150) holds the 2,048-clip epoch
# (8 steps of 256)
DUAL_TECHS = (("original", 128), ("deepfakes", 32), ("face2face", 32), ("faceswap", 32),
              ("neuraltextures", 32))                 # (technique, videos)
DUAL_CLIPS, DUAL_FRAMES = 12, 12
DUAL_BATCH, DUAL_EPOCHS, DUAL_EPOCH_SAMPLES = 256, 3, 2048
DUAL_TIMED_STEPS = 20
# one float32 step on the card against the same step on the CPU (TF32 off,
# dropout 0, the same SLERP draws): the loss within 1e-5 · max(1, |CPU|), the
# gradients' norm within 1e-4 of it, Adam's moments within 1e-4 (mu, the
# gradients' trace) and 2e-4 (nu, their squares) of their largest entry over
# all parameters; between the port's own float32 and float64 on the CPU two
# such steps differ by 1.3e-5, 7.5e-6 and 1.6e-5. The parameters within
# 2.5e-5 · max(1, |CPU|): a first Adam step moves each by at most the
# one-cycle's first LR (1.2e-5) whatever its gradient, and a gradient that
# is zero but for rounding (the attention's key bias: softmax ignores a
# shift) takes either sign.
DUAL_F32_TOLS = {"loss": 1e-5, "grad_norm": 1e-4, "mu": 1e-4, "nu": 2e-4, "params": 2.5e-5}
# best.msgpack holds the float32 weights exactly, so the reloaded model's
# logits equal the trained model's (0.0 expected; the bound allows another
# kernel choice for the same GEMMs)
DUAL_RELOAD_TOL = 1e-5


def write_feature_tree(root: str, rng) -> int:
    """``<tech>/<name>/track_0/clip_k/{au,lmk}_features.npy``: reals a slow
    random walk plus noise in every channel, each fake technique a frame-rate
    flicker of its own amplitude on every fourth channel from one of its own
    (a cue the per-clip z-score keeps); → the number of clips."""
    n = 0
    for k, (tech, videos) in enumerate(DUAL_TECHS):
        for v in range(videos):
            for c in range(DUAL_CLIPS):
                d = os.path.join(root, tech, f"{tech[:3]}{v:03d}", "track_0", f"clip_{c}")
                os.makedirs(d)
                feats = []
                for dim in (36, 132):
                    x = (np.cumsum(rng.randn(DUAL_FRAMES, dim) * 0.3, axis=0)
                         + rng.randn(DUAL_FRAMES, dim) * 0.5)
                    if k:
                        ch = np.arange(dim)[(np.arange(dim) % 4) == k - 1]
                        x[:, ch] += (1.0 + 0.5 * k) * ((-1.0) ** np.arange(DUAL_FRAMES))[:, None]
                    feats.append(x.astype(np.float32))
                np.save(os.path.join(d, "au_features.npy"), feats[0])
                np.save(os.path.join(d, "lmk_features.npy"), feats[1])
                n += 1
    return n


class _EpochClock(logging.Handler):
    """The times the trainer logs each epoch's line (and the line before its
    first), for the epochs' wall time."""

    def __init__(self):
        super().__init__()
        self.marks = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(("train clips=", "[epoch ")):
            self.marks.append(record.created)


def dual_batch(data: dict, idx, dev) -> dict:
    return {"A": torch.from_numpy(data["A"][idx]).to(dev),
            "L": torch.from_numpy(data["L"][idx]).to(dev),
            "y": torch.from_numpy(data["y"][idx]).to(dev),
            "lengths": torch.from_numpy(data["lengths"][idx]).to(dev),
            "dom_id": torch.from_numpy(data["dom_id"][idx]).to(dev)}


def dual_setup(dev, n_domains: int, dropout: float = 0.15, dp=None, dtype=torch.float32):
    """The shipped model (run_dual's defaults: d_model 256, 4 layers, 4
    heads, DAT) on ``dev`` in ``dtype``, its AdamW chain over a 3-epoch
    one-cycle of 8 steps an epoch, and the step (data-parallel over
    ``dp``); → (model, state, step, trains-everything mask)."""
    from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
    from stdd_torch.train import engine_dual as eng
    from stdd_torch.train.altfreeze import active_mask_from_labels, dual_labels
    from stdd_torch.train.step import TrainState

    model = DualEncoderAU_LMK(dropout=dropout, use_dat=True, domain_classes=n_domains,
                              seed=SEED).to(dev, dtype)
    args = eng.DualTrainArgs(epochs=DUAL_EPOCHS, batch=DUAL_BATCH)
    tx = eng.make_dual_optimizer(args, eng.make_schedule(
        args, DUAL_EPOCH_SAMPLES // DUAL_BATCH))
    params = dict(model.named_parameters())
    state = TrainState(params, {}, tx.init(params), 0)
    mask = active_mask_from_labels(dual_labels(params), ("au", "lmk", "other"))
    return model, state, eng.make_dual_train_step(model, tx, args, dp=dp), mask


def dual_f32_card_vs_cpu(dev, data: dict, n_domains: int) -> dict:
    """One float32 step of the dual trainer on the card and on the CPU from
    the same weights, batch and SLERP draws, dropout 0."""
    from stdd_torch.train.engine_dual import slerp_draws

    idx = np.arange(DUAL_BATCH)
    draws = slerp_draws(torch.from_numpy(data["y"][idx]).int(), 0.1, 0.4,
                        torch.Generator().manual_seed(SEED))
    out = {}
    for where in ("cpu", dev):
        model, state, step, mask = dual_setup(where, n_domains, dropout=0.0)
        model.head_dropout = 0.0
        state, m = step(state, dual_batch(data, idx, where), mask, 0.1, SEED,
                        draws=tuple(d.to(where) for d in draws))
        adam = state.opt_state[1][0]
        out[str(where)] = (float(m["loss"]), float(m["grad_norm"]),
                           {k: v.detach().double().cpu() for k, v in state.params.items()},
                           {f: {k: v.double().cpu() for k, v in adam[f].items()}
                            for f in ("mu", "nu")})
    (lc, gc, pc, ac), (lg, gg, pg, ag) = out["cpu"], out[str(dev)]

    def over_largest(a, b):
        return (max(float((a[k] - b[k]).abs().max()) for k in b)
                / max(float(b[k].abs().max()) for k in b))

    return {"loss": abs(lg - lc) / max(1.0, abs(lc)), "grad_norm": abs(gg - gc) / gc,
            "params": max(float((pg[k] - pc[k]).abs().max()) / max(1.0, float(pc[k].abs().max()))
                          for k in pc),
            "mu": over_largest(ag["mu"], ac["mu"]), "nu": over_largest(ag["nu"], ac["nu"]),
            "loss_cpu": lc, "grad_norm_cpu": gc}


def phase_dual(dev, smi: str, tmp_dir: str) -> None:
    """``stdd_torch.train.run_dual.main`` on the card at the shipped run's
    width (d_model 256, 4 layers, 4 heads, FF 512, dropout 0.15, DAT, SLERP,
    one-cycle AdamW at 3e-4, clip 1.0, T 8, batch 256, float32) over a
    synthetic feature tree the script writes: 3 epochs of 2048 sampled clips,
    validation, temperature, calibrated threshold, ``best.msgpack`` and the
    test report. Then ``best.msgpack`` reloaded in a fresh model; the step's
    device time on a fixed batch (CUDA events), peak memory and the
    profiler's busy share; the host's ``load_all``; and (phase ``dual_f32``)
    a float32 step on the card against the CPU's."""
    from stdd_torch.data.dataset import DualFeaturesClipDataset
    from stdd_torch.data.splits import make_split
    from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
    from stdd_torch.train import run_dual
    from stdd_torch.train.engine_dual import collect_logits
    from stdd_torch.utils.logging import get_logger
    from stdd_torch.utils.msgpack import msgpack_restore
    from stdd_torch.utils.weights import dual_flax_to_torch

    tree, out = os.path.join(tmp_dir, "features"), os.path.join(tmp_dir, "dual_run")
    n_clips = write_feature_tree(tree, np.random.RandomState(SEED + 15))   # set-up, not timed
    # run_dual's split: the same clips and seed
    split = make_split(sorted(glob.glob(os.path.join(tree, "**", "track_*", "clip_*"),
                                        recursive=True)), seed=SEED)
    clock = _EpochClock()
    get_logger("train").addHandler(clock)
    argv = ["--data", tree, "--out", out, "--epochs", str(DUAL_EPOCHS),
            "--epoch_samples", str(DUAL_EPOCH_SAMPLES), "--seed", str(SEED), "--device", str(dev)]
    # the dual path starts here
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    t0 = time.perf_counter()
    res = run_dual.main(argv)
    seconds = time.perf_counter() - t0
    k1, k2 = warp_affine.launches, fused_bottleneck.launches    # ... ends here
    k3n = k3_read("dual")
    get_logger("train").removeHandler(clock)
    history = res["history"]
    # run_dual caps an epoch at the training split's size: the tree must hold
    # enough clips for DUAL_EPOCH_SAMPLES, the epoch dual_setup times
    steps_per_epoch = min(DUAL_EPOCH_SAMPLES, len(split["train"]) // 2 * 2) // DUAL_BATCH
    with open(os.path.join(out, "report_median.json")) as f:
        report = json.load(f)
    losses = [h["loss"] for h in history]
    if not np.isfinite(losses).all():
        raise AssertionError(f"dual: epoch losses {losses} are not finite")

    # best.msgpack reloaded in a fresh model scores the validation clips as
    # the trained model does
    train_ds = DualFeaturesClipDataset(clip_dirs=split["train"], T=8, is_train=True,
                                       aug_noise_au=0.05, aug_noise_lmk=0.01, seed=SEED)
    val = DualFeaturesClipDataset(clip_dirs=split["val"], T=8).load_all()
    trained = DualEncoderAU_LMK(use_dat=True, domain_classes=train_ds.n_domains).to(dev)
    trained.load_state_dict(res["params"])
    reloaded = DualEncoderAU_LMK(use_dat=True, domain_classes=train_ds.n_domains)
    with open(os.path.join(out, "best.msgpack"), "rb") as f:
        reloaded.load_state_dict(dual_flax_to_torch(msgpack_restore(f.read()), reloaded))
    reloaded.to(dev)
    want, _ = collect_logits(trained, val)
    got, _ = collect_logits(reloaded, val)
    reload_err = float(np.abs(got - want).max())
    if not reload_err <= DUAL_RELOAD_TOL:
        raise AssertionError(f"dual: best.msgpack reloaded scores {reload_err} away")
    del trained, reloaded

    # the host's load_all of the training split, as each epoch re-draws it
    load_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        train = train_ds.load_all()
        load_s.append(time.perf_counter() - t0)

    # the step alone on the card: the shipped model, one fixed batch
    model, st, step, mask = dual_setup(dev, train_ds.n_domains)
    batch = dual_batch(train, np.arange(DUAL_BATCH), dev)
    for _ in range(3):                                          # warm-up
        st, m = step(st, batch, mask, 0.1, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(DUAL_TIMED_STEPS)]
    for a, b in evs:
        a.record()
        st, m = step(st, batch, mask, 0.1, SEED)
        b.record()
    torch.cuda.synchronize()
    step_ms = np.array([a.elapsed_time(b) for a, b in evs])
    peak = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            st, m = step(st, batch, mask, 0.1, SEED)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1000
    busy_ms, top = device_busy(prof, steps=5)
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 5
    del model, st, batch
    torch.cuda.empty_cache()

    epochs_s = np.diff(clock.marks).tolist()
    r = {"phase": "dual", "card": smi, "model": "DualEncoderAU_LMK", "d_model": 256,
         "layers": 4, "heads": 4, "T": 8, "batch": DUAL_BATCH, "dtype": "float32",
         "clips_written": n_clips, "split": {k: len(v) for k, v in split.items()},
         "epochs": DUAL_EPOCHS, "epoch_samples": DUAL_EPOCH_SAMPLES,
         "steps_per_epoch": steps_per_epoch, "seconds_run_dual": seconds,
         "epoch_wall_s": epochs_s, "load_all_s": load_s, "epoch_loss": losses,
         "val_auc": [h["val_auc"] for h in history], "phases": [h["phase"] for h in history],
         "temperature": res["temperature"], "threshold_calibrated": res["threshold_calibrated"],
         "test_clip_auc": report["clip_metrics"]["auc_roc"],
         "test_video_auc": report["video_metrics"]["auc_roc"],
         "k1_launches": k1, "k2_launches": k2, "k3_launches": k3n,
         "reload_max_abs_logit_err": reload_err,
         "step_ms_median": float(np.median(step_ms)),
         "step_ms_p90": float(np.percentile(step_ms, 90)),
         "clips_per_s": DUAL_BATCH * 1000.0 / float(np.median(step_ms)),
         "max_memory_allocated_gib": peak / 2 ** 30,
         "profiled_steps": 5, "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
         "device_busy_share": busy_ms / prof_wall_ms, "kernels_per_step": n_kernels,
         "top_kernels_ms_per_step": top}
    emit(r)
    if k1 or k2 or k3n:
        raise AssertionError(f"dual: K1/K2/K3 launched {k1}/{k2}/{k3n} times on the dual path")
    if steps_per_epoch != DUAL_EPOCH_SAMPLES // DUAL_BATCH:
        raise AssertionError(f"dual: {steps_per_epoch} steps an epoch; the tree is too small")
    if len(history) != DUAL_EPOCHS:
        raise AssertionError(f"dual: {len(history)} epochs ran, not {DUAL_EPOCHS}")
    for name in ("best.msgpack", "best_threshold.txt", "best_threshold_calibrated.txt",
                 "temperature.txt", "args.json", "history.json", "report_median.json"):
        if not os.path.isfile(os.path.join(out, name)):
            raise AssertionError(f"dual: {name} was not written")
    if not 0.0 <= report["clip_metrics"]["auc_roc"] <= 1.0:
        raise AssertionError(f"dual: test clip AUC {report['clip_metrics']['auc_roc']}")

    f32 = dual_f32_card_vs_cpu(dev, train, train_ds.n_domains)
    emit({"phase": "dual_f32", "card": smi, **f32, "tol": DUAL_F32_TOLS})
    for key, tol in DUAL_F32_TOLS.items():
        if not f32[key] <= tol:
            raise AssertionError(f"dual_f32: float32 card vs CPU {key} {f32[key]} > {tol}")


# -- the data-production plane: landmarker, AU ResNet-18, preprocess, trainer ----

# bounds written before the first card run of these phases. The packaged
# landmarker and the AU model on the card against the same weights on the
# CPU, float32 with TF32 off: 1e-4 on the crop-normalized points, theta and
# AU activations (convolution sums in another order; the CPU tests hold the
# port to JAX at 1e-5). The landmarker's key-landmark error against the
# renderer's ground truth: < 0.01 crop-normalized, JAX's own bound
# (tests/test_facemesh.py:181).
LANDMARK_FACES = 16
LANDMARK_TOLS = {"card_vs_cpu_points": 1e-4, "card_vs_cpu_theta": 1e-4, "key_err": 0.01}
AU_TOL = 1e-4
# preprocess: 64 frames of a 1080p BenchScene with 4 faces; clip 8, step 4
# → 15 clips a track. The dense landmarks of the clip tree against the
# renderer's mesh of the same face and frame: mean |Δ| over the key
# landmarks ≤ PRE_PX_TOL frame pixels (faces of 288 px; the landmarker's
# 0.01 crop-normalized bound is ~3.7 px of its 374-px crop)
PRE_HW, PRE_FRAMES, PRE_FACES = (1080, 1920), 64, 4
PRE_PX_TOL = 4.0
# landmarker training at the shipped batch
LMT_BATCH, LMT_STEPS, LMT_TIMED = 256, 60, 10


def phase_landmarker(dev, smi: str):
    """The packaged ``LandmarkNet`` (width 32) on 16 faces rendered on the
    card from seeded parameters: the same net on the CPU (float32, TF32
    off), the key-landmark error against the renderer's mesh, and faces/s
    of the forward at batch 1 and 16 (CUDA events) and of the whole
    ``DenseLandmarker`` call on a frame (host crop and resize, forward,
    copy back; host clock)."""
    from stdd_torch.models.facemesh import (DenseLandmarker, canonical_mesh, reconstruct,
                                            render_faces, sample_params)
    from stdd_torch.train.train_landmarker import _key_indices

    gen = torch.Generator(dev).manual_seed(SEED)
    rigid, theta, style = sample_params(gen, LANDMARK_FACES, device=dev)
    imgs = render_faces(rigid, theta, style)
    lm = DenseLandmarker.pretrained(device=dev)
    lm_cpu = DenseLandmarker.pretrained(device="cpu")
    pg, tg = lm.forward(imgs)
    pc, tc = lm_cpu.forward(imgs.cpu())
    key = torch.as_tensor(_key_indices(), dtype=torch.long)
    gt = reconstruct(torch.from_numpy(canonical_mesh()), rigid.cpu(), theta.cpu())[:, key]
    r = {"phase": "landmarker", "card": smi, "faces": LANDMARK_FACES, "width": 32,
         "card_vs_cpu_points": float((pg.cpu() - pc).abs().max()),
         "card_vs_cpu_theta": float((tg.cpu() - tc).abs().max()),
         "key_err": float((pg.cpu()[:, key] - gt).abs().mean()),
         "key_err_cpu": float((pc[:, key] - gt).abs().mean())}
    canon = torch.from_numpy(canonical_mesh()).to(dev)
    with torch.no_grad():
        for B in (1, 16):
            ms = event_ms(lambda: lm.forward(imgs[:B]), reps=20)
            r[f"forward_ms_b{B}"] = ms
            r[f"faces_per_s_b{B}"] = B * 1000.0 / ms
            # the split: the CNN alone, and the mesh reconstruction alone
            r[f"net_ms_b{B}"] = event_ms(lambda: lm.net(imgs[:B]), reps=20)
            r[f"reconstruct_ms_b{B}"] = event_ms(
                lambda: reconstruct(canon, rigid[:B], theta[:B]), reps=20)
    frame = (imgs[0].cpu().numpy() * 255).astype(np.uint8)
    frame = np.ascontiguousarray(np.repeat(np.repeat(frame, 3, 0), 3, 1))   # a 384-px face
    call_ms = wall_ms(lambda: lm(frame, (40, 40, 344, 344)), 20)
    r["call_ms"] = call_ms
    r["call_faces_per_s"] = 1000.0 / call_ms
    emit(r)
    for k, tol in LANDMARK_TOLS.items():
        if not r[k] <= tol:
            raise AssertionError(f"landmarker: {k} {r[k]} > {tol}")


def phase_au(dev, smi: str):
    """AU ResNet-18 at 224² with random weights, bridged through the flax
    tree, on the card against the same weights on the CPU; faces/s at batch
    4 and 16 (preprocess + forward, CUDA events)."""
    from stdd_torch.models.au_resnet import AUExtractor, preprocess_faces
    from stdd_torch.utils.weights import torch_to_flax

    cpu = AUExtractor.random_init(seed=SEED, device="cpu")
    au = AUExtractor(torch_to_flax(cpu.model.state_dict()), device=dev)
    faces = np.random.RandomState(SEED).randint(0, 256, (16, 224, 224, 3), np.uint8)
    err = float(np.abs(au.activations(faces[:8]) - cpu.activations(faces[:8])).max())
    r = {"phase": "au", "card": smi, "model": "AUResNet18", "input": 224,
         "weights": "random", "card_vs_cpu_act": err}
    x = torch.from_numpy(faces).to(dev)
    with torch.no_grad():
        for B in (4, 16):
            ms = event_ms(lambda: au.model(preprocess_faces(x[:B])), reps=10)
            r[f"ms_b{B}"] = ms
            r[f"faces_per_s_b{B}"] = B * 1000.0 / ms
    r["call_ms_b4"] = wall_ms(lambda: au(faces[:4]), 10)
    emit(r)
    if not err <= AU_TOL:
        raise AssertionError(f"au: card vs CPU activations {err} > {AU_TOL}")
    return au


def landmark_px_error(tree: str, scene) -> dict:
    """Mean |Δ| (frame px) over the key landmarks between the clip tree's
    dense landmarks and the renderer's mesh of the same face and frame; a
    track is matched to the face whose mesh lies nearest its first
    frame."""
    from stdd_torch.train.train_landmarker import _key_indices

    key = _key_indices()
    errs, per_track = [], {}
    for clip in sorted(glob.glob(os.path.join(tree, "**", "track_*", "clip_*"), recursive=True)):
        lms = np.load(os.path.join(clip, "landmarks.npy"), allow_pickle=True)
        fids = np.load(os.path.join(clip, "frame_ids.npy"))
        track = os.path.basename(os.path.dirname(clip))
        for pts, fid in zip(lms, fids):
            mesh = scene.mesh(int(fid))
            face = int(np.argmin(np.abs(mesh.mean(axis=1) - np.asarray(pts).mean(axis=0)).sum(1)))
            per_track.setdefault(track, set()).add(face)
            errs.append(float(np.abs(np.asarray(pts, np.float32)[key] - mesh[face][key]).mean()))
    return {"mean_px": float(np.mean(errs)), "max_frame_px": float(np.max(errs)),
            "frames": len(errs), "faces_per_track": {k: sorted(v) for k, v in per_track.items()}}


def phase_preprocess(dev, smi: str, tmp_dir: str, au):
    """``PreprocessPipeline.process_video`` on a 1080p BenchScene with 4
    faces (64 frames written to a .y4m before any clock starts), with the
    packaged landmarker, the AU model and a detector that runs
    ``detect_scaled`` on the YuNet-shaped random graph for its device cost
    and returns the scene's oracle rows. Then the tree is checked (tracks,
    clips, sentinel, landmarks against the mesh), converted to features,
    loaded in ``DualFeaturesClipDataset`` and scored by the dual model; and
    the CLI ``main`` runs once over the same file on the random graph."""
    from stdd_torch.data import preprocess as pre
    from stdd_torch.data.dataset import DualFeaturesClipDataset
    from stdd_torch.data.features import compute_norm_stats, process_clip_tree
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.models.dual_encoder import DualEncoderAU_LMK
    from stdd_torch.models.facemesh import DenseLandmarker
    from stdd_torch.train.engine_dual import collect_logits
    from stdd_torch.utils.video_io import read_y4m, write_y4m

    scene = BenchScene(PRE_HW, n_faces=PRE_FACES, seed=SEED, device=dev)
    vids = os.path.join(tmp_dir, "videos")
    os.makedirs(vids)
    video = os.path.join(vids, "scene.y4m")
    write_y4m(video, (scene.frame(i) for i in range(PRE_FRAMES)))        # set-up, not timed
    onnx = write_onnx(yunet_shaped_graph(SEED), os.path.join(tmp_dir, "yunet_shaped.onnx"))
    det = YuNet(onnx, device=dev)
    count = {"i": 0}

    def detect_fn(frame):
        detect_scaled(det, frame)                    # the detector's device cost
        rows = scene.oracle(count["i"])
        count["i"] += 1
        return rows

    lm = DenseLandmarker.pretrained(device=dev)
    pipe = pre.PreprocessPipeline(detect_fn, au_extractor=au, landmarker=lm)
    detect_fn(scene.frame(0))                        # warm-up: cuDNN picks its algorithms
    au(np.zeros((PRE_FACES, 224, 224, 3), np.uint8))
    lm(scene.frame(0), (100, 100, 400, 400))
    count["i"] = 0
    tree = os.path.join(tmp_dir, "clips")
    writer = pre.ClipWriter(tree)
    torch.cuda.synchronize()
    # the preprocess path starts here
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    perf = pipe.process_video(video, writer, "scene")
    writer.close()
    k1, k2 = warp_affine.launches, fused_bottleneck.launches   # ... ends here
    k3n = k3_read("preprocess")
    with open(os.path.join(tree, "master_clip_log.csv")) as f:
        log = list(csv.DictReader(f))
    tracks = sorted({r["track_id"] for r in log})
    want_clips = PRE_FACES * ((PRE_FRAMES - pre.CLIP_LENGTH) // pre.CLIP_STEP + 1)
    px = landmark_px_error(tree, scene)
    feats = process_clip_tree(tree)
    stats_path = compute_norm_stats(tree, os.path.join(tree, "norm_stats.npz"))
    ds = DualFeaturesClipDataset(root_dir=tree, T=8)
    data = ds.load_all()
    model = DualEncoderAU_LMK(seed=SEED).to(dev).eval()
    logits, _ = collect_logits(model, data)
    del model

    # the host's share that no stage clock covers: decoding the file alone
    t0 = time.perf_counter()
    n_read = sum(1 for _ in read_y4m(video))
    decode_s = time.perf_counter() - t0

    argv = ["--video_root", vids, "--out_dir", os.path.join(tmp_dir, "cli"), "--yunet_model",
            onnx, "--au_ckpt", "random", "--features", "--device", str(dev)]
    t0 = time.perf_counter()
    cli_logs = pre.main(argv)
    cli_s = time.perf_counter() - t0

    r = {"phase": "preprocess", "card": smi, "frame_hw": list(PRE_HW), "faces": PRE_FACES,
         "frames": perf["frames"], "clips": perf["clips"], "clips_expected": want_clips,
         "tracks": len(tracks), "flagged_clips": sum(r["lm_flagged"] == "True" for r in log),
         "frames_per_s": perf["frames"] / perf["t_total"],
         **{k: perf[k] for k in ("t_detect", "t_au", "t_landmark", "t_total")},
         "t_decode_alone": decode_s, "frames_decoded_alone": n_read,
         "landmarks_vs_mesh_px": px, "features": feats, "norm_stats": os.path.basename(stats_path),
         "dataset_clips": len(ds), "dual_logits_finite": bool(np.isfinite(logits).all()),
         "dual_logits_shape": list(logits.shape), "detections_real": False,
         "detector": "YuNet-shaped graph, random weights (device cost); BenchScene.oracle rows",
         "au_weights": "random", "k1_launches": k1, "k2_launches": k2, "k3_launches": k3n,
         "cli_seconds": cli_s, "cli_frames": sum(l["frames"] for l in cli_logs),
         "cli_clips": sum(l["clips"] for l in cli_logs), "writer_errors": len(writer.errors)}
    emit(r)
    if k1 or k2 or k3n:
        raise AssertionError(f"preprocess: K1/K2/K3 launched {k1}/{k2}/{k3n} times on the "
                             "preprocess path")
    if perf["frames"] != PRE_FRAMES or len(tracks) != PRE_FACES or perf["clips"] != want_clips:
        raise AssertionError(f"preprocess: {perf['frames']} frames, {len(tracks)} tracks, "
                             f"{perf['clips']} clips (want {PRE_FRAMES}, {PRE_FACES}, {want_clips})")
    if r["flagged_clips"] or writer.errors:
        raise AssertionError(f"preprocess: {r['flagged_clips']} flagged clips, "
                             f"{len(writer.errors)} failed writes")
    if any(len(v) != 1 for v in px["faces_per_track"].values()):
        raise AssertionError(f"preprocess: a track changed faces: {px['faces_per_track']}")
    if not px["mean_px"] <= PRE_PX_TOL:
        raise AssertionError(f"preprocess: landmarks {px['mean_px']} px from the mesh > {PRE_PX_TOL}")
    if feats["lmk_ok"] != want_clips or feats["au_ok"] != want_clips or len(ds) != want_clips:
        raise AssertionError(f"preprocess: features {feats}, dataset {len(ds)} clips")
    if not r["dual_logits_finite"] or logits.shape[0] != want_clips:
        raise AssertionError(f"preprocess: dual logits {logits.shape}, finite {r['dual_logits_finite']}")
    if r["cli_frames"] != PRE_FRAMES:
        raise AssertionError(f"preprocess: the CLI read {r['cli_frames']} frames")


def phase_landmarker_train(dev, smi: str):
    """``train_landmarker.train`` on the card at the shipped batch of 256
    for LMT_STEPS steps (render, augment, forward, backward, Adam on the
    cosine schedule): the loss must fall. Then the step's device time on the
    trained net (CUDA events), peak memory and ``holdout_error``."""
    from stdd_torch.models.facemesh import canonical_mesh
    from stdd_torch.train import optim
    from stdd_torch.train import train_landmarker as tl

    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    t0 = time.perf_counter()
    lm = tl.train(steps=LMT_STEPS, batch=LMT_BATCH, log_every=1, verbose=True, device=dev)
    seconds = time.perf_counter() - t0
    k1, k2, k3n = warp_affine.launches, fused_bottleneck.launches, k3_read("landmarker_train")
    hist = lm.history
    net = lm.net.train()
    tx = optim.adam(optim.cosine_decay_schedule(3e-4, 1000, alpha=0.1))
    state = tx.init(dict(net.named_parameters()))
    step = tl.make_train_step(net, tx, torch.from_numpy(canonical_mesh()).to(dev),
                              tl._key_indices(), batch=LMT_BATCH)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    for _ in range(3):
        state, loss, _ = step(state, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(LMT_TIMED)]
    for a, b in evs:
        a.record()
        state, loss, _ = step(state, gen)
        b.record()
    torch.cuda.synchronize()
    step_ms = np.array([a.elapsed_time(b) for a, b in evs])
    peak = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(3):
            state, loss, _ = step(state, gen)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1000
    busy_ms, top = device_busy(prof, steps=3)
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 3
    net.eval()
    first, last = float(np.mean(hist[:5])), float(np.mean(hist[-5:]))
    r = {"phase": "landmarker_train", "card": smi, "batch": LMT_BATCH, "steps": LMT_STEPS,
         "seconds_train": seconds, "loss_first5": first, "loss_last5": last, "loss": hist,
         "step_ms_median": float(np.median(step_ms)), "step_ms_p90": float(np.percentile(step_ms, 90)),
         "faces_per_s": LMT_BATCH * 1000.0 / float(np.median(step_ms)),
         "max_memory_allocated_gib": peak / 2 ** 30, "device_busy_share": busy_ms / prof_wall_ms,
         "kernels_per_step": n_kernels, "top_kernels_ms_per_step": top,
         "holdout_error": tl.holdout_error(lm), "k1_launches": k1, "k2_launches": k2,
         "k3_launches": k3n}
    emit(r)
    if not np.isfinite(hist).all() or not last < first:
        raise AssertionError(f"landmarker_train: the loss did not fall ({first} → {last})")
    if k1 or k2 or k3n:
        raise AssertionError(f"landmarker_train: K1/K2/K3 launched {k1}/{k2}/{k3n} times")


# -- phases 21-23: the offline evaluation harnesses --------------------------------

# four 720p BenchScene videos (two under real/, two under fake/, which the
# harness's path tokens label), one face each, 96 frames, written as .y4m
# before any clock starts. The face's sprite is 128 px: its box (about 92 ×
# 115 px) clears the harness's min_det_side of 80, and its big box (at most
# 234 px) fits the 256-px crop buffer unscaled, so the demo's dense and
# packed paths hand the scorer the same bytes. (A downscaled crop takes one
# scale per clip on the packed path and one per track on the dense path: the
# pixels then differ by design, as JAX's own test of the two allows 2e-3.)
EVAL_HW, EVAL_FACE_PX, EVAL_FRAMES = (720, 1280), 128, 96
EVAL_LABELS = ("real", "real", "fake", "fake")
# the JAX harness CLI's defaults (stdd_tpu/eval/harness.py:344-367)
HARNESS_ARGS = dict(clip_size=32, stride=5, detect_every=4, batch_clips=8, crop_scale=0.5,
                    crop_buffer=256, threshold=0.4, min_det_side=80, det_conf=0.6)
HARNESS_CLI_FRAMES = 48
DEMO_BATCH = 8
# probs of a scorer loaded from the reference-format file written from
# another scorer's weights, against that scorer: the same float32 weights
# in the same model (0.0 expected)
REFERENCE_CKPT_TOL = 1e-6


def write_eval_videos(tmp_dir: str, dev):
    """[(path, label, scene)] of the four videos, rendered on ``dev``."""
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.utils.video_io import write_y4m

    videos = []
    for k, label in enumerate(EVAL_LABELS):
        scene = BenchScene(EVAL_HW, n_faces=1, seed=SEED + 20 + k, face_px=EVAL_FACE_PX,
                           device=dev)
        path = os.path.join(tmp_dir, "videos", label, f"scene{k}.y4m")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_y4m(path, (scene.frame(i) for i in range(EVAL_FRAMES)))
        videos.append((path, int(label == "fake"), scene))
    return videos


def phase_reference_ckpt(dev, smi: str, scorer, tmp_dir: str, frames, cache) -> str:
    """The phase scorer's weights written as a reference ``.pth``
    (``{"classifier": state_dict}`` under the reference's keys), served by
    ``ClipScorer.from_torch_checkpoint``: the same weights and, on 8 windows
    of the first video, the same probs (``REFERENCE_CKPT_TOL``). Returns the
    file's path, which the harness CLI then serves."""
    from stdd_torch.eval.demo import build_clips
    from stdd_torch.utils.torch_convert import i3d_torch_to_reference

    T = HARNESS_ARGS["clip_size"]
    path = os.path.join(tmp_dir, "i3d_reference.pth")
    t0 = time.perf_counter()
    torch.save({"classifier": i3d_torch_to_reference(scorer.model.state_dict()), "epoch": 0},
               path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ClipScorer.from_torch_checkpoint(path, cfg=scorer.cfg, upload_format="rgb",
                                              device=dev)
    load_s = time.perf_counter() - t0
    src_sd, got_sd = scorer.model.state_dict(), loaded.model.state_dict()
    same = sorted(src_sd) == sorted(got_sd) and all(torch.equal(src_sd[k], got_sd[k])
                                                    for k in src_sd)
    clips = build_clips(*cache, frames, T)
    batch = pack_clip_batch(clips[::len(clips) // 8][:8], 8, T, HARNESS_ARGS["crop_buffer"])
    want, got = scorer.score(*batch), loaded.score(*batch)
    dp = float(np.abs(got - want).max())
    emit({"phase": "reference_ckpt", "card": smi, "file_mb": os.path.getsize(path) / 2 ** 20,
          "tensors": len(src_sd), "save_s": save_s, "load_s": load_s, "weights_equal": same,
          "probs": got.tolist(), "vs_source_max_dp": dp, "tol": REFERENCE_CKPT_TOL})
    del loaded
    if not same:
        raise AssertionError("reference_ckpt: the loaded weights differ from the source's")
    if not (np.isfinite(got).all() and ((got > 0) & (got < 1)).all()):
        raise AssertionError(f"reference_ckpt: probs not finite in (0, 1): {got}")
    if not dp <= REFERENCE_CKPT_TOL:
        raise AssertionError(f"reference_ckpt: |Δp| vs the source scorer {dp} > "
                             f"{REFERENCE_CKPT_TOL}")
    return path


def phase_harness(dev, smi: str, scorer, videos, tmp_dir: str, onnx: str, ref_path: str):
    """``harness.run_video`` → ``summarize`` → ``write_csvs`` over the four
    videos at the JAX CLI's defaults, RGB upload, the engine warmed up as
    the CLI warms it, the detector the scene's oracle (``"detections_real":
    false``); then the CLI itself over a list file with ``--ckpt`` = the
    reference-format file and YuNet on the random YuNet-shaped graph.
    Returns the path's K1 and K2 launches."""
    from stdd_torch.eval import harness

    a = HARNESS_ARGS
    pipe = PipelineConfig(clip_size=a["clip_size"], stride=a["stride"],
                          detect_every=a["detect_every"], batch_clips=a["batch_clips"],
                          threshold=a["threshold"], pool_method="mean",
                          min_face_side=a["min_det_side"], crop_scale=a["crop_scale"])
    oracle = {"scene": None, "calls": 0}

    def detect_fn(frame_bgr):
        # the engine detects on every detect_every-th frame, in order
        i = oracle["calls"] * pipe.detect_every
        oracle["calls"] += 1
        return oracle["scene"].oracle(i)

    eng = StreamingEngine(scorer, detect_fn, cfg=pipe, crop_buffer=a["crop_buffer"],
                          start_conf=a["det_conf"])
    rows, batches, clip_scores = [], 0, []
    try:
        eng.warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the harness path starts here
        fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
        t0 = time.perf_counter()
        for path, gt, scene in videos:
            oracle.update(scene=scene, calls=0)
            r = harness.run_video(eng, path, a["threshold"])
            batches += eng._group._next_seq               # reset() zeroes it per video
            clip_scores.append([p for s in eng.track_clip_scores.values() for p in s])
            r.update(gt_label=gt, dataset=harness.dataset_of(path),
                     subset=harness.subset_of(path),
                     device_mem_peak_mb=harness.device_mem_peak_mb(dev), model_size=0,
                     cold_start=False)
            rows.append(r)
        wall = time.perf_counter() - t0
        k1, k2 = warp_affine.launches, fused_bottleneck.launches   # ... ends here
        k3n = k3_read("harness")
    finally:
        eng.close()
    # the host's share that no engine clock covers: decoding one video alone
    t0 = time.perf_counter()
    n_read = sum(1 for _ in harness.iter_video_frames(videos[0][0]))
    decode_s = time.perf_counter() - t0
    summary = harness.summarize(rows, 0)
    out_dir = os.path.join(tmp_dir, "harness")
    harness.write_csvs(rows, summary, out_dir, a["threshold"])
    with open(os.path.join(out_dir, "per_video.csv")) as f:
        per_video = list(csv.reader(f))
    with open(os.path.join(out_dir, "summary.csv")) as f:
        summary_csv = list(csv.reader(f))
    windows = sum(len(s) for s in clip_scores)
    res = {"phase": "harness", "card": smi, "detections_real": False,
           "detector": "BenchScene.oracle rows", "frame_hw": list(EVAL_HW),
           "face_px": EVAL_FACE_PX, "frames_per_video": EVAL_FRAMES, **a,
           "upload_format": scorer.upload_format, "videos": len(rows),
           "frames_processed": [r["frames_processed"] for r in rows],
           "num_tracks": [r["num_tracks"] for r in rows],
           "windows_per_video": [len(s) for s in clip_scores],
           "video_scores": [r["video_score"] for r in rows],
           "pred_labels": [r["pred_label"] for r in rows],
           "fps_per_video": [r["fps"] for r in rows],
           "latency_ms_clip_mean": [r["latency_ms_clip_mean"] for r in rows],
           "device_mem_peak_mb": [r["device_mem_peak_mb"] for r in rows],
           "seconds": wall, "windows_scored": windows, "windows_per_s": windows / wall,
           "t_decode_alone_one_video": decode_s, "frames_decoded_alone": n_read,
           "batches_dispatched": batches, "k1_launches": k1, "k2_launches": k2,
           "k3_launches": k3n,
           "summary": {k: summary[k] for k in ("accuracy", "auc_roc", "mean_fps",
                                                "mean_latency_ms_clip")}}
    emit(res)
    flat = [p for s in clip_scores for p in s] + [r["video_score"] for r in rows]
    if any(r["frames_processed"] != EVAL_FRAMES or r["num_tracks"] != 1 for r in rows):
        raise AssertionError(f"harness: frames {res['frames_processed']}, tracks "
                             f"{res['num_tracks']} (want {EVAL_FRAMES} and 1 a video)")
    if not all(clip_scores) or not all(np.isfinite(p) and 0.0 < p < 1.0 for p in flat):
        raise AssertionError(f"harness: scores not finite in (0, 1) or a video unscored: "
                             f"{clip_scores}")
    if per_video[0] != harness.PER_VIDEO_HEADER or summary_csv[0] != harness.SUMMARY_HEADER \
            or len(per_video) != len(rows) + 1:
        raise AssertionError(f"harness: CSV headers {per_video[0]} / {summary_csv[0]}")
    if not k1 == batches > 0 or k2:
        raise AssertionError(f"harness: K1 launches {k1} != scored batches {batches}, "
                             f"K2 launches {k2}")

    # the CLI, in its own process, as an analyst runs it
    lst = os.path.join(tmp_dir, "videos.txt")
    with open(lst, "w") as f:
        f.write("\n".join(path for path, _, _ in videos) + "\n")
    cli_out = os.path.join(tmp_dir, "harness_cli")
    cmd = [sys.executable, "-m", "stdd_torch.eval.harness", "--video_list", lst, "--out_dir",
           cli_out, "--yunet_model", onnx, "--ckpt", ref_path, "--max_frames",
           str(HARNESS_CLI_FRAMES), "--clip_size", str(a["clip_size"])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    cli_rows = []
    if proc.returncode == 0:
        with open(os.path.join(cli_out, "per_video.csv")) as f:
            cli_rows = list(csv.DictReader(f))
    emit({"phase": "harness_cli", "card": smi, "detections_real": False,
          "detector": "YuNet-shaped graph, random weights", "returncode": proc.returncode,
          "wall_s": cli_s, "max_frames": HARNESS_CLI_FRAMES, "rows": len(cli_rows),
          "fps": [float(r["fps"]) for r in cli_rows],
          "num_tracks": [int(r["num_tracks"]) for r in cli_rows],
          "video_scores": [float(r["video_score"]) for r in cli_rows],
          "model_size": [int(r["model_size"]) for r in cli_rows],
          # no track means no window scored; the CSV does not count windows
          # of a started track, so then the number is left open
          "windows_scored": (0 if not any(int(r["num_tracks"]) for r in cli_rows)
                             else "not counted by per_video.csv"),
          "stdout_tail": proc.stdout[-600:]})
    if proc.returncode != 0 or len(cli_rows) != len(videos):
        raise AssertionError(f"harness CLI: exit {proc.returncode}, {len(cli_rows)} rows; "
                             f"stderr: {proc.stderr[-3000:]}")
    ref_size = os.path.getsize(ref_path)
    if any(int(r["frames_processed"]) != HARNESS_CLI_FRAMES
           or int(r["model_size"]) != ref_size for r in cli_rows):
        raise AssertionError(f"harness CLI: frames_processed / model_size "
                             f"{[(r['frames_processed'], r['model_size']) for r in cli_rows]}, "
                             f"want {HARNESS_CLI_FRAMES} and {ref_size} on every row")
    return k1, k2


def phase_demo(dev, smi: str, scorer, frames, cache):
    """``demo.eval_video`` on the first video with the oracle's detections
    in the cache layout (the 68-point tile): ``dense=True``, then the packed
    path over the same stride-1 windows, batch 8. Returns each path's K1 and
    K2 launches."""
    from stdd_torch.eval import demo

    T = HARNESS_ARGS["clip_size"]
    want = EVAL_FRAMES - T + 1
    forwards = -(-want // DEMO_BATCH)
    runs = {}
    for name, dense in (("dense", True), ("packed", False)):
        torch.cuda.synchronize()
        # the demo's path starts here
        fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
        r = demo.eval_video(scorer, frames, detect_res=cache[0], lm68s=cache[1], clip_size=T,
                            crop_buffer=HARNESS_ARGS["crop_buffer"], batch=DEMO_BATCH,
                            dense=dense)
        runs[name] = (r, warp_affine.launches, fused_bottleneck.launches)   # ... ends here
        k3_read(f"demo_{name}")
    (rd, k1d, k2d), (rp, k1p, k2p) = runs["dense"], runs["packed"]
    # the packed path's host share: packing its batches alone
    clips = demo.build_clips(*cache, frames, T)
    t0 = time.perf_counter()
    for i in range(0, len(clips), DEMO_BATCH):
        pack_clip_batch(clips[i:i + DEMO_BATCH], DEMO_BATCH, T, HARNESS_ARGS["crop_buffer"])
    pack_s = time.perf_counter() - t0
    dp = float(np.abs(np.subtract(rd["preds"], rp["preds"])).max())
    boxes = [get_crop_box(frames[0].shape[:2], face[0], HARNESS_ARGS["crop_scale"])
             for faces in cache[0] for face in faces]
    big = int(max(max(b[2] - b[0], b[3] - b[1]) for b in boxes))
    res = {"phase": "demo", "card": smi, "detections_real": False, "frames": rd["frames"],
           "clip": T, "batch": DEMO_BATCH, "forwards": forwards, "max_big_box_px": big,
           "pack_scale": min(1.0, HARNESS_ARGS["crop_buffer"] / big),
           **{f"{k}_{n}": runs[n][0][k] for n in runs
              for k in ("clips", "video_score", "t_detect", "t_aligninfer", "fps_model",
                        "fps_end2end")},
           "t_pack_alone_packed": pack_s, "k1_launches_dense": k1d, "k1_launches_packed": k1p,
           "k2_launches": k2d + k2p, "k3_launches_dense": k3_by_path["demo_dense"],
           "k3_launches_packed": k3_by_path["demo_packed"], "dense_vs_packed_dp": dp,
           "tol": DENSE_TOL}
    emit(res)
    preds = np.asarray(rd["preds"] + rp["preds"])
    if not rd["clips"] == rp["clips"] == want:
        raise AssertionError(f"demo: {rd['clips']} dense / {rp['clips']} packed windows "
                             f"(want {want})")
    if not (np.isfinite(preds).all() and ((preds > 0) & (preds < 1)).all()):
        raise AssertionError("demo: probs not finite in (0, 1)")
    if not dp <= DENSE_TOL:
        raise AssertionError(f"demo: dense vs packed |Δp| {dp} > {DENSE_TOL}")
    if k1d != forwards or k1p != forwards or k2d or k2p:
        raise AssertionError(f"demo: K1 launches {k1d} / {k1p} (want {forwards} each), "
                             f"K2 {k2d + k2p}")
    k3d, k3p = k3_by_path["demo_dense"], k3_by_path["demo_packed"]
    if not k3d == k3p == K3_PER_FORWARD["i3d"] * forwards:
        raise AssertionError(f"demo: K3 launches {k3d} / {k3p} (want "
                             f"{K3_PER_FORWARD['i3d'] * forwards} each)")
    return {"demo_dense": k1d, "demo_packed": k1p}, {"demo_dense": k2d, "demo_packed": k2p}


def phase_eval(dev, smi: str, main_scorer, tmp_dir: str):
    """The three evaluation phases with an RGB-upload scorer over the main
    scorer's weights (I3D-R50, 32×224², bf16); their wall time. Returns
    {kernel: {phase: launches}}."""
    from stdd_torch.eval.demo import cache_from_rows
    from stdd_torch.eval.harness import iter_video_frames

    t_start = time.perf_counter()
    scorer = ClipScorer(main_scorer.model.state_dict(), cfg=main_scorer.cfg,
                        upload_format="rgb", device=dev)
    videos = write_eval_videos(tmp_dir, dev)
    onnx = write_onnx(yunet_shaped_graph(SEED), os.path.join(tmp_dir, "yunet_shaped.onnx"))
    path0, _, scene0 = videos[0]
    frames0 = [f[:, :, ::-1] for f in iter_video_frames(path0)]          # RGB, as demo.main
    cache0 = cache_from_rows(scene0.oracle(i) for i in range(len(frames0)))
    setup_s = time.perf_counter() - t_start
    walls = {}
    t0 = time.perf_counter()
    ref_path = phase_reference_ckpt(dev, smi, scorer, tmp_dir, frames0, cache0)
    walls["reference_ckpt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k1h, k2h = phase_harness(dev, smi, scorer, videos, tmp_dir, onnx, ref_path)
    walls["harness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k1d, k2d = phase_demo(dev, smi, scorer, frames0, cache0)
    walls["demo"] = time.perf_counter() - t0
    emit({"phase": "eval_wall", "setup_s": setup_s, **{f"{k}_s": v for k, v in walls.items()},
          "seconds": time.perf_counter() - t_start})
    return {"warp_affine": {"harness": k1h, **k1d}, "fused_bottleneck": {"harness": k2h, **k2d}}


# -- the synthetic capstone and the dual family's fusion ----------------------------

# the capstone at full width (720p, clip 32, crop 224, the I3D-R50 trained and
# served in bf16, the dual encoder at its shipped width) and reduced depth:
# 2 train pairs (of 8), 1 eval pair (of 6), 64 frames (of 140), 1 I3D epoch
# (of 5), 2 dual epochs (of 12)
CAPSTONE_ARGS = ["--dual", "--fresh", "--train_pairs", "2", "--eval_pairs", "1",
                 "--frames", "64", "--epochs", "1"]
CAPSTONE_DUAL_EPOCHS = 2
# the fusion phase: the feature dump's engine (every stride-1 window, so a
# 64-frame video gives 33 clips, 4 windows of T), DualEncoderRGB at full
# width and the dual trainer's batch, one step of the dual trainer's
# optimizer (clip, AdamW, the one-cycle's first LR of 1.2e-5) card vs CPU
# within DUAL_F32_TOLS' bounds for the loss, the gradients' norm and the
# parameters (a first Adam step moves a parameter by at most that LR, of
# either sign for a gradient that is zero but for rounding), the gated
# fusion's 200 Adam steps card vs CPU, and landmark pretraining on
# synthetic sequences
FUSION_T, FUSION_BATCH, FUSION_TIMED_STEPS = 8, 256, 10
FUSION_TOLS = {k: DUAL_F32_TOLS[k] for k in ("loss", "grad_norm", "params")}
MOE_EPOCHS, MOE_TOL = 200, 1e-5
PRETRAIN_N, PRETRAIN_T, PRETRAIN_EPOCHS, PRETRAIN_BATCH = 2048, 8, 3, 64


def phase_capstone(dev, smi: str, tmp_dir: str):
    """``stdd_torch.eval.synth_e2e.main`` with ``--dual`` on the card at full
    width and reduced depth (``CAPSTONE_ARGS``): render → preprocess →
    run_i3d → the harness with K1 → run_dual. The JSON contract of JAX's two
    capstone tests, no ``dual_error``, and K1 launches equal to the harness's
    warm-up plus its scored batches (> 0), K2 none. Returns (result, --out,
    K1, K2)."""
    from stdd_torch.eval import harness, synth_e2e

    out = os.path.join(tmp_dir, "synth_e2e")
    count = {"batches": 0, "warmup_k1": 0}
    run_video, build_engine, full = harness.run_video, harness.build_engine, synth_e2e.FULL

    def counting_run_video(engine, *a, **k):
        r = run_video(engine, *a, **k)
        count["batches"] += engine._group._next_seq            # reset() zeroes it per video
        return r

    def counting_build_engine(args, detect_fn=None):
        built = build_engine(args, detect_fn)
        count["warmup_k1"] = warp_affine.launches               # the engine's warm-up
        return built

    harness.run_video, harness.build_engine = counting_run_video, counting_build_engine
    synth_e2e.FULL = dict(full, dual_epochs=CAPSTONE_DUAL_EPOCHS)
    try:
        torch.cuda.synchronize()
        # the capstone's path starts here
        fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
        t0 = time.perf_counter()
        res = synth_e2e.main(CAPSTONE_ARGS + ["--out", out, "--device", str(dev)])
        seconds = time.perf_counter() - t0
        k1, k2 = warp_affine.launches, fused_bottleneck.launches   # ... ends here
        k3n = k3_read("capstone")
    finally:
        harness.run_video, harness.build_engine, synth_e2e.FULL = run_video, build_engine, full
    emit({"phase": "capstone", "card": smi, "argv": CAPSTONE_ARGS,
          "dual_epochs": CAPSTONE_DUAL_EPOCHS, "seconds": seconds, "result": res,
          "k1_launches": k1, "k1_warmup_launches": count["warmup_k1"],
          "scored_batches": count["batches"], "k2_launches": k2, "k3_launches": k3n})
    aucs = [res.get(k) for k in ("video_auc", "dual_video_auc", "dual_clip_auc")]
    if "dual_error" in res:
        raise AssertionError(f"capstone: phase 5 failed: {res['dual_error']}")
    if res["eval_videos"] != 2 or res["train_ckpt_epoch"] < 1 or res["detections_real"]:
        raise AssertionError(f"capstone: eval_videos {res['eval_videos']}, train_ckpt_epoch "
                             f"{res['train_ckpt_epoch']}, detections_real {res['detections_real']}")
    if not all(a is not None and 0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"capstone: AUCs {aucs} not in [0, 1]")
    if set(res["phase_wall_s"]) != {"render", "preprocess", "train", "eval", "dual"}:
        raise AssertionError(f"capstone: phases {sorted(res['phase_wall_s'])}")
    if not res.get("lm_clips", 0) > 0:
        raise AssertionError("capstone: the dense landmarker logged no clip")
    if not (k1 - count["warmup_k1"] == count["batches"] > 0) or k2:
        raise AssertionError(f"capstone: K1 launches {k1} != warm-up {count['warmup_k1']} + "
                             f"scored batches {count['batches']}, K2 launches {k2}")
    return res, out, k1, k2


def device_step_ms(step, reps: int) -> float:
    """Median device time of one ``step()`` over ``reps`` calls (CUDA events
    around each, after one warm-up call)."""
    step()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for a, b in evs:
        a.record()
        step()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def kernels_per_call(fn, calls: int = 3) -> float:
    """Device kernels ``fn()`` launches a call (the profiler's CUDA events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) / calls


def dump_eval_features(dev, out: str, res: dict, feat_dir: str):
    """``dump_video_features`` over the capstone's eval videos with the
    checkpoint it served (RGB upload, bf16), each video's oracle rows as the
    detector, every stride-1 window. Returns (npz paths, scored batches)."""
    import re

    from stdd_torch.eval import synth_e2e
    from stdd_torch.eval.features import dump_video_features
    from stdd_torch.runtime.classifier import load_scorer
    from stdd_torch.utils.video_io import read_y4m

    cfg = synth_e2e.FULL
    scorer = load_scorer(None, os.path.join(out, res["served_ckpt"]), cfg["clip_size"],
                         cfg["crop"], upload_format="rgb", device=dev)
    batches = [0]
    score = scorer.score_with_features

    def counting(*a, **k):
        batches[0] += 1
        return score(*a, **k)

    scorer.score_with_features = counting
    pipe = PipelineConfig(clip_size=cfg["clip_size"], stride=1, detect_every=4,
                          batch_clips=8, min_face_side=10)
    paths = []
    for video in sorted(glob.glob(os.path.join(out, "videos_eval", "*", "*.y4m"))):
        label = os.path.basename(os.path.dirname(video))
        seed = int(re.search(r"vid_(\d+)", video).group(1))
        frames = list(read_y4m(video))
        scene = synth_e2e.scene_of(seed, label, cfg["frame_hw"], cfg["face_px"], device=dev)
        oracle = synth_e2e.OracleDetector(
            {video: np.stack([scene.oracle(i) for i in range(len(frames))])},
            every=pipe.detect_every, conf=synth_e2e.DET_CONF).switch(video)
        path = os.path.join(feat_dir, f"{label}_{os.path.basename(video)[:-4]}.npz")
        dump_video_features(scorer, frames, oracle, cfg=pipe, crop_buffer=cfg["crop_buffer"],
                            q_weighting=False, q_lap_hard=0.0, out_path=path)
        paths.append(path)
    del scorer
    return paths, batches[0]


def rgb_fusion_step(where, A, L, R, lengths, y):
    """One float32 step of ``DualEncoderRGB`` at full width on ``where``
    from the seed's weights, dropout 0, with the dual trainer's optimizer
    (``dual_setup``'s: clip 1.0, AdamW, a one-cycle over 3 epochs of 8
    steps). Returns (model, loss, the gradients' norm, the features' tensor,
    step)."""
    from stdd_torch.models.dual_rgb import DualEncoderRGB
    from stdd_torch.train import engine_dual as eng
    from stdd_torch.train.losses import bce_with_logits
    from stdd_torch.train.optim import global_norm

    model = DualEncoderRGB(dropout=0.0, seed=SEED).to(where)
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    args = eng.DualTrainArgs(epochs=DUAL_EPOCHS, batch=FUSION_BATCH)
    tx = eng.make_dual_optimizer(args, eng.make_schedule(args, DUAL_EPOCH_SAMPLES // DUAL_BATCH))
    state = {"opt": tx.init(params)}
    A, L, R, lengths, y = (torch.from_numpy(x).to(where) for x in (A, L, R, lengths, y))
    R.requires_grad_(True)

    def step():
        for p in params.values():
            p.grad = None
        loss = bce_with_logits(model(A, L, R, lengths=lengths, train=True)["bin_logits"], y)
        loss.backward()
        with torch.no_grad():
            grads = {k: p.grad for k, p in params.items()}
            updates, state["opt"] = tx.update(grads, state["opt"], params)
            for k, p in params.items():
                p.add_(updates[k])
        return loss.detach(), global_norm(grads)

    loss, gnorm = step()
    return model, loss, gnorm, R, step


def phase_fusion(dev, smi: str, out: str, res: dict, tmp_dir: str):
    """The dual family's fusion on the capstone's outputs. The feature path:
    ``dump_video_features`` over its eval videos with its served checkpoint
    (K1 on every scored batch), ``load_feature_clips(T=8)``, then one
    float32 AdamW step of ``DualEncoderRGB`` at full width on a batch of
    256 on the card and on the CPU (``FUSION_TOLS``; no gradient reaches
    ``rgb_proj`` or the features), and the step's device time and kernels.
    The fusion fit: ``align_scores`` of the harness's ``per_video.csv`` (its
    keys made unique: ``real_vid_100``, ``fake_vid_100``) with the dual
    model's per-video scores, then ``train_moe`` on the card and the CPU
    (``MOE_TOL``). Pretraining: ``pretrain_lmk`` on synthetic landmark
    sequences; the loss must fall and the last epoch's accuracy pass 0.5.
    Returns (K1, K2)."""
    from stdd_torch.data.dataset import DualFeaturesClipDataset
    from stdd_torch.eval.best import aggregate_videos
    from stdd_torch.eval.features import load_feature_clips
    from stdd_torch.models.dual_encoder import DualEncoderAU_LMK, LMKDisc
    from stdd_torch.train.engine_dual import collect_logits
    from stdd_torch.train.engine_fusion import align_scores, train_moe
    from stdd_torch.train.metrics import sigmoid
    from stdd_torch.train.optim import adamw
    from stdd_torch.train.pretrain import WEIGHT_DECAY, make_pretrain_step, pretrain_lmk
    from stdd_torch.train.step import TrainState
    from stdd_torch.utils.msgpack import msgpack_restore
    from stdd_torch.utils.weights import dual_flax_to_torch

    t_start = time.perf_counter()
    feat_dir = os.path.join(tmp_dir, "rgb_features")
    os.makedirs(feat_dir)
    torch.cuda.synchronize()
    # the fusion path starts here
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    paths, batches = dump_eval_features(dev, out, res, feat_dir)
    clips = load_feature_clips(paths, FUSION_T)
    dump_s = time.perf_counter() - t_start

    test_dirs = sorted(glob.glob(os.path.join(out, "clips_eval", "**", "track_*", "clip_*"),
                                 recursive=True))
    ds = DualFeaturesClipDataset(clip_dirs=test_dirs, T=FUSION_T)
    data = ds.load_all()
    idx, ridx = (np.arange(FUSION_BATCH) % n for n in (len(data["y"]), len(clips["rgb"])))
    batch = (data["A"][idx], data["L"][idx], clips["rgb"][ridx], data["lengths"][idx],
             data["y"][idx])
    runs = {}
    for where in ("cpu", dev):
        model, loss, gnorm, R, step = rgb_fusion_step(where, *batch)
        runs[str(where)] = (model, float(loss), float(gnorm), R)
    (mc, lc, gc, _), (mg, lg, gg, Rg) = runs["cpu"], runs[str(dev)]
    pc, pg = mc.state_dict(), mg.state_dict()
    rgb_err = {"loss": abs(lg - lc) / max(1.0, abs(lc)), "grad_norm": abs(gg - gc) / gc,
               "params": max(float((pg[k].cpu() - pc[k]).abs().max())
                             / max(1.0, float(pc[k].abs().max())) for k in pc)}
    frozen = (mg.rgb_proj.weight.grad is None and Rg.grad is None
              and torch.equal(pg["rgb_proj.weight"].cpu(), pc["rgb_proj.weight"]))
    rgb_ms = device_step_ms(step, FUSION_TIMED_STEPS)
    rgb_kernels = kernels_per_call(step)
    del runs, mc, mg, step

    # the dual model's per-video scores of the eval videos, as its report scores them
    dual_dir = os.path.join(out, "dual")
    dual = DualEncoderAU_LMK(au_dim=ds.au_dim, lmk_dim=ds.lmk_dim)
    with open(os.path.join(dual_dir, "best.msgpack"), "rb") as f:
        dual.load_state_dict(dual_flax_to_torch(msgpack_restore(f.read()), dual))
    with open(os.path.join(dual_dir, "temperature.txt")) as f:
        temperature = float(f.read())
    logits, y = collect_logits(dual.to(dev), data)
    meta = [(ds.tech_names[i], ds.vid_keys[i], int(data["trk"][i])) for i in range(len(y))]
    videos = aggregate_videos(meta, y, sigmoid(logits / temperature), 0.5)
    dual_scores = {k.split("::", 1)[1].replace("/", "_"): v["video_score"]
                   for k, v in videos.items()}
    # the harness's CSV with unique keys: a real video and its fake share a name
    csv_path = os.path.join(tmp_dir, "per_video_keyed.csv")
    with open(os.path.join(out, "results", "per_video.csv")) as f, \
            open(csv_path, "w", newline="") as g:
        rows = list(csv.DictReader(f))
        w = csv.DictWriter(g, fieldnames=list(rows[0]))
        w.writeheader()
        for r in rows:
            label = os.path.basename(os.path.dirname(r["video_path"]))
            w.writerow(dict(r, video_path=f"{label}_{os.path.basename(r['video_path'])}"))
    z_rgb, z_dual, yv, keys = align_scores(csv_path, dual_scores)
    t0 = time.perf_counter()
    moe = {str(where): train_moe(z_rgb, z_dual, yv, epochs=MOE_EPOCHS, log=lambda s: None,
                                 device=where) for where in (dev, "cpu")}
    moe_s = time.perf_counter() - t0
    moe_err = {k: float(np.abs(moe[str(dev)][k] - moe["cpu"][k]).max())
               for k in ("fused_probs", "gates")}

    # landmark pretraining on smooth synthetic trajectories with ragged lengths
    rng = np.random.RandomState(SEED + 40)
    t = np.linspace(0, 1, PRETRAIN_T)[None, :, None]
    seqs = np.sin(2 * np.pi * (t * rng.uniform(0.5, 2.0, (PRETRAIN_N, 1, 1))
                               + rng.uniform(0, 1, (PRETRAIN_N, 1, 132)))).astype(np.float32)
    lengths = rng.randint(4, PRETRAIN_T + 1, PRETRAIN_N).astype(np.int64)
    seqs[np.arange(PRETRAIN_T)[None, :] >= lengths[:, None]] = 0.0
    disc = LMKDisc(seed=SEED)
    t0 = time.perf_counter()
    pre = pretrain_lmk(disc, seqs, lengths, epochs=PRETRAIN_EPOCHS, batch=PRETRAIN_BATCH,
                       log=lambda s: None, device=dev)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    tx = adamw(3e-4, WEIGHT_DECAY)
    named = dict(disc.named_parameters())
    pstate = {"s": TrainState(named, {}, tx.init(named), 0)}
    pstep = make_pretrain_step(disc, tx)
    Lb = torch.from_numpy(seqs[:PRETRAIN_BATCH]).to(dev)
    lb = torch.from_numpy(lengths[:PRETRAIN_BATCH]).to(dev)

    def pretrain_step():
        pstate["s"], m = pstep(pstate["s"], Lb, lb, SEED)
        return m["loss"]

    pre_ms = device_step_ms(pretrain_step, FUSION_TIMED_STEPS)
    k1, k2 = warp_affine.launches, fused_bottleneck.launches      # ... ends here
    k3_read("fusion")
    hist = pre["history"]
    emit({"phase": "fusion", "card": smi, "feature_videos": len(paths),
          "feature_clips_scored": int(sum(len(np.load(p)["feats"]) for p in paths)),
          "rgb_windows": int(len(clips["rgb"])), "dump_s": dump_s, "k1_launches": k1,
          "scored_batches": batches, "k2_launches": k2,
          "rgb_model": "DualEncoderRGB au 36 lmk 132 vis 2048 d 256 depth 4 heads 4",
          "rgb_batch": FUSION_BATCH, "rgb_card_vs_cpu": rgb_err, "rgb_tols": FUSION_TOLS,
          "rgb_frozen_branch": frozen, "rgb_step_ms": rgb_ms, "rgb_kernels_per_step": rgb_kernels,
          "moe_keys": keys, "moe_labels": yv.tolist(), "z_rgb": z_rgb.tolist(),
          "z_dual": z_dual.tolist(), "dual_temperature": temperature,
          "moe_card": {k: v for k, v in moe[str(dev)].items() if k != "params"
                       and not isinstance(v, np.ndarray)},
          "moe_fused_probs": moe[str(dev)]["fused_probs"].tolist(),
          "moe_card_vs_cpu": moe_err, "moe_tol": MOE_TOL, "moe_s_both": moe_s,
          "pretrain_sequences": PRETRAIN_N, "pretrain_history": hist, "pretrain_s": pre_s,
          "pretrain_steps": PRETRAIN_EPOCHS * (PRETRAIN_N // PRETRAIN_BATCH),
          "pretrain_step_ms": pre_ms, "seconds": time.perf_counter() - t_start})
    if not (k1 == batches > 0) or k2:
        raise AssertionError(f"fusion: K1 launches {k1} != scored batches {batches}, K2 {k2}")
    if not len(clips["rgb"]) or clips["rgb"].shape[1:] != (FUSION_T, 2048):
        raise AssertionError(f"fusion: feature windows {clips['rgb'].shape}")
    for key, tol in FUSION_TOLS.items():
        if not rgb_err[key] <= tol:
            raise AssertionError(f"fusion: DualEncoderRGB card vs CPU {key} {rgb_err[key]} > {tol}")
    if not frozen:
        raise AssertionError("fusion: a gradient reached rgb_proj or the features")
    if len(keys) != 2 or len(set(keys)) != len(keys):
        raise AssertionError(f"fusion: align_scores keys {keys}")
    if not all(v <= MOE_TOL for v in moe_err.values()):
        raise AssertionError(f"fusion: train_moe card vs CPU {moe_err} > {MOE_TOL}")
    if not (hist[-1]["loss"] < hist[0]["loss"] and hist[-1]["acc"] > 0.5):
        raise AssertionError(f"fusion: pretraining did not learn: {hist}")
    return k1, k2


def phase_capstone_fusion(dev, smi: str):
    """The capstone, then the fusion phase on its outputs, in one scratch
    directory. Returns {kernel: {phase: launches}}."""
    with tempfile.TemporaryDirectory() as tmp_dir:
        res, out, k1c, k2c = phase_capstone(dev, smi, tmp_dir)
        k1f, k2f = phase_fusion(dev, smi, out, res, tmp_dir)
    return {"warp_affine": {"capstone": k1c, "fusion": k1f},
            "fused_bottleneck": {"capstone": k2c, "fusion": k2f}}



# -- phases 26-29: video-file input and the rest of data production -------------

APP_FILE_HW, APP_FILE_FRAMES, APP_FILE_CLI_FRAMES = (720, 1280), 120, 48
APP_FILE_TOL = 1e-6        # the same frames reach the same engine: 0.0 expected
REGEN_HW, REGEN_FRAMES, REGEN_T, REGEN_STRIDE = (720, 1280), 48, 8, 2
REGEN_VIDEOS = ("original", "original", "deepfakes", "deepfakes")
VOX_SPEAKERS, VOX_CLIPS, VOX_T, VOX_BATCH = 16, 20, 32, 64
LF_HW = (480, 640)


def oracle_rows(scene, n: int) -> np.ndarray:
    """[n, faces, 15] rows the scene drew in its first ``n`` frames."""
    return np.stack([scene.oracle(i) for i in range(n)])


def run_app_over(scorer, frames, rows) -> dict:
    """``RealtimeApp`` + ``run_loop`` at ``phase_app``'s operating point
    with the scene's oracle rows as the detector; K1's count zeroed just
    before the run and read just after."""
    from stdd_torch.eval.synth_e2e import OracleDetector

    pipe = PipelineConfig(**ENGINE_PIPE)
    oracle = OracleDetector({"v": rows}, pipe.detect_every, 0.0).switch("v")
    eng = StreamingEngine(scorer, AsyncDetector(oracle), cfg=pipe, **ENGINE_KW)
    app = RealtimeApp(eng, threshold=pipe.threshold)
    try:
        eng.warmup()
        seq0 = eng._group._next_seq
        # the run starts here
        warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0
        t0 = time.perf_counter()
        ready, fake = run_loop(app, frames)
        dt = time.perf_counter() - t0
        launches, k2 = warp_affine.launches, fused_bottleneck.launches   # ... ends here
        k3n = k3.bias_act.launches
        batches = eng._group._next_seq - seq0
    finally:
        eng.close()
    return {"seconds": dt, "fps": app.frames_seen / dt, "frames_seen": app.frames_seen,
            "meeting_ready": bool(ready), "meeting_fake": bool(fake),
            "scores": {int(t): [float(p) for p in v] for t, v in app.running_scores.items()},
            "k1_launches": launches, "k2_launches": k2, "k3_launches": k3n,
            "batches_dispatched": batches}


def phase_app_file(scorer, smi: str, tmp_dir: str) -> int:
    """The app over a ``.y4m`` file: a 720p ``BenchScene`` with one face,
    120 frames, written before any clock starts; ``RealtimeApp`` +
    ``run_loop`` over ``sources.iter_video_file`` with the scene's oracle
    rows, then over the same decoded frames held in memory (the same
    probabilities); then ``python -m stdd_torch.runtime.app --source FILE``
    in its own process on the YuNet-shaped random graph. Returns K1's
    launches on the file run."""
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.runtime import sources
    from stdd_torch.utils.video_io import read_y4m, write_y4m

    scene = BenchScene(APP_FILE_HW, n_faces=1, seed=SEED + 60, device=str(scorer.device))
    path = os.path.join(tmp_dir, "call.y4m")
    write_y4m(path, (scene.frame(i) for i in range(APP_FILE_FRAMES)))       # set-up
    rows = oracle_rows(scene, APP_FILE_FRAMES)
    t0 = time.perf_counter()
    decoded = list(read_y4m(path))
    decode_s = time.perf_counter() - t0
    fil = run_app_over(scorer, sources.iter_video_file(path), rows)
    mem = run_app_over(scorer, iter(decoded), rows)
    k3_read("app_file", fil["k3_launches"])
    same_tracks = sorted(fil["scores"]) == sorted(mem["scores"]) and all(
        len(fil["scores"][t]) == len(mem["scores"][t]) for t in fil["scores"])
    dp = max((abs(a - b) for t in fil["scores"] if same_tracks
              for a, b in zip(fil["scores"][t], mem["scores"][t])), default=float("inf"))

    onnx = write_onnx(yunet_shaped_graph(SEED), os.path.join(tmp_dir, "yunet_shaped.onnx"))
    cmd = [sys.executable, "-m", "stdd_torch.runtime.app", "--source", path, "--max_frames",
           str(APP_FILE_CLI_FRAMES), "--det_model", onnx, "--no_warmup"]
    t0 = time.perf_counter()
    cli = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    cli_frames = [ln for ln in cli.stdout.splitlines() if ln.startswith("frames: ")]
    r = {"phase": "app_file", "card": smi, "frame_hw": list(APP_FILE_HW),
         "frames": APP_FILE_FRAMES, "file_mb": os.path.getsize(path) / 1e6,
         "detector": "BenchScene.oracle rows", "detections_real": False,
         "fps_file": fil["fps"], "fps_memory": mem["fps"], "decode_alone_s": decode_s,
         "decode_ms_per_frame": 1000.0 * decode_s / len(decoded),
         "k1_launches": fil["k1_launches"], "batches_dispatched": fil["batches_dispatched"],
         "k1_launches_memory": mem["k1_launches"], "k2_launches": fil["k2_launches"],
         "k3_launches": fil["k3_launches"],
         "frames_seen": fil["frames_seen"],
         "scored_tracks": fil["scores"], "file_vs_memory_dp": dp, "tol": APP_FILE_TOL,
         "meeting_ready": fil["meeting_ready"], "meeting_fake": fil["meeting_fake"],
         "cli_rc": cli.returncode, "cli_seconds": cli_s, "cli_frames_line": cli_frames,
         "cli_verdict": [ln for ln in cli.stdout.splitlines() if ln.startswith("meeting")],
         "cli_note": "YuNet-shaped random graph: no track starts, no window is scored"}
    emit(r)
    flat = [p for v in fil["scores"].values() for p in v]
    if not (fil["k1_launches"] == fil["batches_dispatched"] > 0 and flat and not fil["k2_launches"]
            and np.isfinite(flat).all() and fil["frames_seen"] == APP_FILE_FRAMES):
        raise AssertionError(f"app_file: K1 {fil['k1_launches']}, batches "
                             f"{fil['batches_dispatched']}, frames {fil['frames_seen']}, "
                             f"scores {fil['scores']}")
    if not (same_tracks and dp <= APP_FILE_TOL):
        raise AssertionError(f"app_file: file vs memory |dp| {dp} > {APP_FILE_TOL} "
                             f"({fil['scores']} vs {mem['scores']})")
    if cli.returncode != 0 or cli_frames != [f"frames: {APP_FILE_CLI_FRAMES}"]:
        raise AssertionError(f"app_file: the CLI exited {cli.returncode} with "
                             f"{cli_frames}: {cli.stderr[-2000:]}")
    return fil["k1_launches"], fil["k2_launches"]


class OracleLandmarker:
    """The regen dataset's landmarker on the card: the packaged
    ``DenseLandmarker`` at the box the scene drew. ``read`` stands in for
    ``regen.read_frames_strided``: it times the decode and notes the boxes
    of the frames read; the k-th call then uses the k-th box (a dropped
    frame shifts later calls by one frame, ≤ 3.6 px of a 288-px face)."""

    def __init__(self, lm, scenes, read_fn):
        self.lm, self.scenes, self.read_fn = lm, scenes, read_fn
        self.boxes, self.k, self.points = [], 0, []
        self.t = {"decode": 0.0, "landmarker": 0.0}

    def read(self, path, T, stride=2, start=0):
        t0 = time.perf_counter()
        frames = self.read_fn(path, T, stride, start)
        self.t["decode"] += time.perf_counter() - t0
        scene = self.scenes[path]
        self.boxes = []
        for j in range(len(frames)):
            x, y, w, h = scene.oracle(start + j * stride)[0][:4]
            self.boxes.append((x, y, x + w, y + h))
        self.k = 0
        return frames

    def __call__(self, frame_rgb):
        t0 = time.perf_counter()
        pts = self.lm(frame_rgb, self.boxes[min(self.k, len(self.boxes) - 1)])
        self.t["landmarker"] += time.perf_counter() - t0
        self.k += 1
        self.points.append(pts)
        return pts


class TimedCall:
    """A callable that adds its wall time to ``t[key]``."""

    def __init__(self, fn, t: dict, key: str):
        self.fn, self.t, self.key = fn, t, key

    def __call__(self, *a):
        t0 = time.perf_counter()
        out = self.fn(*a)
        self.t[self.key] += time.perf_counter() - t0
        return out


def degradation_ms(frame) -> dict:
    """Host ms of each degradation on one 720p frame (median of 3)."""
    import random

    from stdd_torch.data import degrade as dg

    ops = {"jpeg_recompress": lambda: dg.jpeg_recompress(frame, 57),
           "down_up": lambda: dg.down_up(frame, 0.73),
           "offcenter_crop": lambda: dg.offcenter_crop(frame, 0.08, random.Random(0)),
           "motion_blur_7": lambda: dg.motion_blur(frame, 7),
           "grayscale": lambda: dg.grayscale(frame),
           "gauss_noise": lambda: dg.gauss_noise(frame, 6.0, np.random.RandomState(0)),
           "gamma_contrast": lambda: dg.gamma_contrast(frame, random.Random(0)),
           "letterbox": lambda: dg.letterbox(frame, random.Random(0))}
    return {k: float(np.median([1000.0 * timed(f) for _ in range(3)])) for k, f in ops.items()}


def phase_regen(dev, smi: str, tmp_dir: str):
    """``DualVideoRegenDataset`` (T 8, stride 2, training draws,
    ``ClipDegrader`` at its defaults) over four 720p ``BenchScene`` videos
    (``original/`` ×2, ``deepfakes/`` ×2, one face, 48 frames) with the
    packaged landmarker at the scene's boxes and the AU ResNet-18 (random
    weights) on the card: ``load_all`` and the split of an item's seconds;
    each degradation's ms on a 720p frame; item 0 on the card against the
    same item on the CPU models; one float32 step of the dual trainer on
    the arrays. Returns the arrays and K1's and K2's launches."""
    from stdd_torch.data import regen
    from stdd_torch.data.degrade import ClipDegrader
    from stdd_torch.data.features import MOUTH_LEFT_IDX, MOUTH_RIGHT_IDX
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.models.au_resnet import AUExtractor
    from stdd_torch.models.facemesh import DenseLandmarker
    from stdd_torch.utils.video_io import write_y4m
    from stdd_torch.utils.weights import torch_to_flax

    scenes, paths = {}, []
    for k, tech in enumerate(REGEN_VIDEOS):
        scene = BenchScene(REGEN_HW, n_faces=1, seed=SEED + 70 + k, device=dev)
        path = os.path.join(tmp_dir, "regen", tech, f"vid_{k}.y4m")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_y4m(path, (scene.frame(i) for i in range(REGEN_FRAMES)))     # set-up
        scenes[path] = scene
        paths.append(path)
    au_cpu = AUExtractor.random_init(seed=SEED, device="cpu")
    au = AUExtractor(torch_to_flax(au_cpu.model.state_dict()), device=dev)
    lm_card = DenseLandmarker.pretrained(device=dev)
    lm_card(scenes[paths[0]].frame(0), (100, 100, 400, 400))     # warm-up: cuDNN's choice
    au(np.zeros((REGEN_T, 256, 256, 3), np.uint8))
    read = regen.read_frames_strided

    def dataset(lm, extractor, t):
        oracle = OracleLandmarker(lm, scenes, read)
        oracle.t = t
        deg = ClipDegrader(seed=SEED)
        deg_timed = TimedCall(deg, t, "degrade")
        ds = regen.DualVideoRegenDataset(paths, landmarker=oracle, T=REGEN_T,
                                         frame_stride=REGEN_STRIDE, is_train=True,
                                         au_extractor=TimedCall(extractor, t, "au"),
                                         degrader=deg_timed, seed=SEED)
        return ds, oracle

    t = dict.fromkeys(("decode", "degrade", "landmarker", "au"), 0.0)
    ds, oracle = dataset(lm_card, au, t)
    regen.read_frames_strided = oracle.read
    try:
        torch.cuda.synchronize()
        # the regen path starts here
        fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
        t0 = time.perf_counter()
        data = ds.load_all()
        load_s = time.perf_counter() - t0
        k1, k2 = warp_affine.launches, fused_bottleneck.launches   # ... ends here
        k3_read("regen")
        # item 0 again on the card and on the CPU models, from fresh datasets
        # of the same seed (the same frames and draws)
        one = {}
        for where, lm, ex in (("card", lm_card, au),
                              ("cpu", DenseLandmarker.pretrained(device="cpu"), au_cpu)):
            d, o = dataset(lm, ex, dict.fromkeys(t, 0.0))
            regen.read_frames_strided = o.read
            one[where] = (d[0], np.stack(o.points))
    finally:
        regen.read_frames_strided = read
    frame = scenes[paths[0]].frame(0, copy=True)
    deg_ms = degradation_ms(frame)
    (card, pc), (cpu, pp) = one["card"], one["cpu"]
    # L is (p - nose) / s, s the mouth width: points off by δ per coordinate
    # move a feature by at most 2δ/s + |L|·2√2δ/s ≤ 3(1 + |L|)δ/s, where δ is
    # the landmarker's card-vs-CPU bound, 1e-4 of its crop (1.3 × the box)
    crop = 1.3 * max(float(sc.oracle(0)[0][2:4].max()) for sc in scenes.values())
    width = float(np.linalg.norm(pp[:, MOUTH_LEFT_IDX] - pp[:, MOUTH_RIGHT_IDX], axis=1).min())
    l_tol = 3 * (1 + float(np.abs(cpu["L"]).max())) * LANDMARK_TOLS["card_vs_cpu_points"] \
        * crop / width
    n = len(ds)
    steps = dual_regen_step(dev, data)
    r = {"phase": "regen", "card": smi, "frame_hw": list(REGEN_HW), "videos": n,
         "frames_per_video": REGEN_FRAMES, "T": REGEN_T, "frame_stride": REGEN_STRIDE,
         "load_all_s": load_s, "s_per_item": load_s / n,
         "split_s_per_item": {k: v / n for k, v in t.items()},
         "lengths": data["lengths"].tolist(), "y": data["y"].tolist(), "tech": data["tech"],
         "au_nonzero_frac": float((data["A"][..., :12] > 0).mean()),
         "degradation_ms_720p": deg_ms, "au_weights": "random",
         "landmarker": "packaged DenseLandmarker at BenchScene.oracle boxes",
         "card_vs_cpu_points_px": float(np.abs(pc - pp).max()),
         "card_vs_cpu_L": float(np.abs(card["L"] - cpu["L"]).max()), "L_tol": l_tol,
         "card_vs_cpu_A": float(np.abs(card["A"] - cpu["A"]).max()), "A_tol": AU_TOL,
         "same_lengths": bool(card["lengths"] == cpu["lengths"]),
         "dual_step": steps, "k1_launches": k1, "k2_launches": k2}
    emit(r)
    if k1 or k2:
        raise AssertionError(f"regen: K1/K2 launched {k1}/{k2} times on the regen path")
    if data["L"].shape != (n, REGEN_T, 132) or data["A"].shape != (n, REGEN_T, 36) \
            or not (data["lengths"] >= 1).all() or data["y"].tolist() != [0, 0, 1, 1]:
        raise AssertionError(f"regen: arrays {data['L'].shape} {data['A'].shape} "
                             f"lengths {data['lengths']} y {data['y']}")
    if not (r["same_lengths"] and r["card_vs_cpu_L"] <= l_tol
            and r["card_vs_cpu_A"] <= AU_TOL):
        raise AssertionError(f"regen: card vs CPU L {r['card_vs_cpu_L']} (tol {l_tol}), "
                             f"A {r['card_vs_cpu_A']} (tol {AU_TOL}), lengths "
                             f"{card['lengths']} vs {cpu['lengths']}")
    if not np.isfinite(steps["loss"]):
        raise AssertionError(f"regen: dual step loss {steps['loss']}")
    return data, k1, k2


def dual_regen_step(dev, data: dict) -> dict:
    """One float32 step of the dual trainer (the shipped width) on the
    regen arrays, with its device time."""
    model, state, step, mask = dual_setup(dev, n_domains=2)
    batch = dual_batch(data, np.arange(len(data["y"])), dev)
    t0 = time.perf_counter()
    state, m = step(state, batch, mask, 0.1, SEED)
    loss = float(m["loss"])
    return {"loss": loss, "grad_norm": float(m["grad_norm"]), "batch": len(data["y"]),
            "first_step_s": time.perf_counter() - t0}


def write_vox_tree(root: str, regen_data: dict) -> int:
    """Speaker folders of ``lmk_features.npy``: the regen items' valid L
    rows (one speaker) and smooth synthetic sequences of 8-64 frames."""
    rng = np.random.RandomState(SEED + 80)
    n = 0
    for i, (L, k) in enumerate(zip(regen_data["L"], regen_data["lengths"])):
        d = os.path.join(root, "id_regen", f"clip{i}")
        os.makedirs(d)
        np.save(os.path.join(d, "lmk_features.npy"), L[:k])
        n += 1
    for s in range(VOX_SPEAKERS):
        for c in range(VOX_CLIPS):
            T = int(rng.randint(8, 65))
            t = np.linspace(0, 1, T)[:, None]
            x = np.sin(2 * np.pi * (t * rng.uniform(0.5, 2.0) + rng.uniform(0, 1, (1, 132))))
            d = os.path.join(root, f"id{s:05d}", f"clip{c}")
            os.makedirs(d)
            np.save(os.path.join(d, "lmk_features.npy"), x.astype(np.float32))
            n += 1
    return n


def phase_vox(dev, smi: str, tmp_dir: str, regen_data: dict):
    """``build_index`` and ``VoxLmkDataset(T=32, is_train=True)
    .batches(64)`` over a speaker tree the script writes, then
    ``pretrain_lmk`` for one epoch on the card on the collated batches:
    the step's time and the loss."""
    from stdd_torch.data.vox import VoxLmkDataset, build_index
    from stdd_torch.models.dual_encoder import LMKDisc
    from stdd_torch.train.optim import adamw
    from stdd_torch.train.pretrain import WEIGHT_DECAY, make_pretrain_step, pretrain_lmk
    from stdd_torch.train.step import TrainState

    root = os.path.join(tmp_dir, "vox")
    files = write_vox_tree(root, regen_data)
    t0 = time.perf_counter()
    index = build_index(root)
    index_s = time.perf_counter() - t0
    ds = VoxLmkDataset(index["train"], T=VOX_T, is_train=True, seed=SEED)
    t0 = time.perf_counter()
    batches = list(ds.batches(VOX_BATCH))
    batches_s = time.perf_counter() - t0
    seqs = np.concatenate([b[0] for b in batches])
    lengths = np.concatenate([b[1] for b in batches]).astype(np.int64)
    disc = LMKDisc(seed=SEED)
    torch.cuda.synchronize()
    # the vox path starts here
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    t0 = time.perf_counter()
    pre = pretrain_lmk(disc, seqs, lengths, epochs=1, batch=VOX_BATCH, log=lambda s: None,
                       device=dev)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    k1, k2 = warp_affine.launches, fused_bottleneck.launches   # ... ends here
    k3_read("vox")
    tx = adamw(3e-4, WEIGHT_DECAY)
    named = dict(disc.named_parameters())
    pstate = {"s": TrainState(named, {}, tx.init(named), 0)}
    pstep = make_pretrain_step(disc, tx)
    Xb, lb = torch.from_numpy(seqs[:VOX_BATCH]).to(dev), torch.from_numpy(lengths[:VOX_BATCH]).to(dev)

    def step():
        pstate["s"], m = pstep(pstate["s"], Xb, lb, SEED)
        return m["loss"]

    step_ms = device_step_ms(step, 10)
    speakers = {os.path.relpath(f, root).split(os.sep)[0] for f in index["train"]}
    val_speakers = {os.path.relpath(f, root).split(os.sep)[0] for f in index["val"]}
    r = {"phase": "vox", "card": smi, "files": files, "train_files": len(index["train"]),
         "val_files": len(index["val"]), "train_speakers": len(speakers),
         "val_speakers": len(val_speakers), "index_s": index_s, "batches": len(batches),
         "batch": VOX_BATCH, "T": VOX_T, "batches_s": batches_s,
         "lengths_min_max": [int(lengths.min()), int(lengths.max())],
         "pretrain_s": pre_s, "pretrain_steps": len(batches),
         "pretrain_history": pre["history"], "step_ms": step_ms, "k1_launches": k1,
         "k2_launches": k2}
    emit(r)
    if k1 or k2:
        raise AssertionError(f"vox: K1/K2 launched {k1}/{k2} times")
    if speakers & val_speakers or len(speakers) + len(val_speakers) < 8 or not batches:
        raise AssertionError(f"vox: speakers {sorted(speakers)} / {sorted(val_speakers)}, "
                             f"{len(batches)} batches")
    if seqs.shape[1:] != (VOX_T, 132) or not np.isfinite(pre["history"][-1]["loss"]):
        raise AssertionError(f"vox: batches {seqs.shape}, history {pre['history']}")
    return k1, k2


class OracleYuNet:
    """Within ``with``: the port's ``YuNet`` builds a stand-in and
    ``detect_scaled`` returns ``rows``, the box the scene drew, as
    ``preprocess``'s ``detector_for`` gives the oracle; YuNet's ONNX is not
    in the repository."""

    def __init__(self, rows):
        from stdd_torch.models import yunet

        self.mod, self.rows, self.calls = yunet, rows, 0
        self.saved = (yunet.YuNet, yunet.detect_scaled)

    def __enter__(self):
        def detect(det, frame_bgr, det_size=None):
            self.calls += 1
            return self.rows.copy()

        self.mod.YuNet = lambda *a, **kw: "oracle"
        self.mod.detect_scaled = detect
        return self

    def __exit__(self, *exc):
        self.mod.YuNet, self.mod.detect_scaled = self.saved


def phase_libreface(dev, smi: str, tmp_dir: str):
    """``stdd_torch.data.libreface_align`` on the card: a rendered face
    frame written as PNG by ``image_io``; ``get_aligned_image`` with the
    scene's box as the detector (``OracleYuNet``) and the packaged
    landmarker on the card; ``image_align`` and the AU ResNet-18 on the
    crop; then ``main`` end to end (``--au_ckpt random``). The ms of each
    step; the landmarks against the renderer's mesh."""
    from stdd_torch.data import libreface_align as lf
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.models.au_resnet import AUExtractor
    from stdd_torch.models.facemesh import DenseLandmarker
    from stdd_torch.train.train_landmarker import _key_indices
    from stdd_torch.utils import image_io

    scene = BenchScene(LF_HW, n_faces=1, seed=SEED + 90, device=dev)
    frame = scene.frame(0, copy=True)
    path = os.path.join(tmp_dir, "face.png")
    ms = {"imwrite_png": 1000.0 * timed(lambda: image_io.imwrite(path, frame))}
    back = {}
    ms["imread_png"] = 1000.0 * timed(lambda: back.setdefault("img", image_io.imread(path)))
    lm = DenseLandmarker.pretrained(device=dev)
    lm(frame[:, :, ::-1], (100, 100, 400, 400))                 # warm-up
    with OracleYuNet(scene.oracle(0)) as oracle:
        res = {}
        ms["get_aligned_image"] = 1000.0 * timed(
            lambda: res.setdefault("r", lf.get_aligned_image(path, landmarker=lm, device=dev)))
        aligned, lms = res["r"]
        img_rgb = back["img"][:, :, ::-1]
        lm72 = np.concatenate([lms["landmarks"][lf.RIGHT_EYE_IDX],
                               lms["landmarks"][lf.LEFT_EYE_IDX], lms["landmarks"][lf.LIPS_IDX]])
        x, y, w, h = scene.oracle(0)[0][:4]
        ms["landmarker"] = 1000.0 * timed(lambda: lm(img_rgb, (x, y, x + w, y + h)))
        ms["image_align"] = 1000.0 * timed(lambda: lf.image_align(img_rgb, lm72))
        au = AUExtractor.random_init(seed=SEED, device=dev)
        au(aligned[None])                                      # warm-up
        acts = {}
        ms["au"] = 1000.0 * timed(lambda: acts.setdefault("a", au.activations(aligned[None])))
        out_dir = os.path.join(tmp_dir, "lf_out")
        t0 = time.perf_counter()
        rc = lf.main(["--image", path, "--out_dir", out_dir, "--au_ckpt", "random",
                      "--device", str(dev)])
        ms["main"] = 1000.0 * (time.perf_counter() - t0)
        calls = oracle.calls
    written = image_io.imread(os.path.join(out_dir, "face_aligned.png"))
    key = _key_indices()
    err = float(np.abs(lms["landmarks"][key] - scene.mesh(0)[0][key]).mean())
    r = {"phase": "libreface", "card": smi, "frame_hw": list(LF_HW), "png_bytes":
         os.path.getsize(path), "png_round_trip_equal": bool(np.array_equal(back["img"], frame)),
         "aligned_shape": list(aligned.shape), "aligned_mean": float(aligned.mean()),
         "landmarks_vs_mesh_px": err, "au_activations": acts["a"][0].tolist(),
         "main_rc": rc, "main_png_equal": bool(np.array_equal(written[:, :, ::-1], aligned)),
         "detector_calls": calls, "detector": "BenchScene.oracle rows", "ms": ms}
    emit(r)
    if not (r["png_round_trip_equal"] and aligned.shape == (256, 256, 3) and rc == 0
            and r["main_png_equal"] and calls == 2 and np.isfinite(acts["a"]).all()):
        raise AssertionError(f"libreface: {r}")
    if not err <= PRE_PX_TOL:
        raise AssertionError(f"libreface: landmarks {err} px from the mesh > {PRE_PX_TOL}")


def phase_data_file(dev, smi: str, scorer) -> dict:
    """Phases 26-29 in one scratch directory; → {kernel: {phase: launches}}."""
    with tempfile.TemporaryDirectory() as tmp_dir:
        k1a, k2a = phase_app_file(scorer, smi, tmp_dir)
    with tempfile.TemporaryDirectory() as tmp_dir:
        data, k1r, k2r = phase_regen(dev, smi, tmp_dir)
        k1v, k2v = phase_vox(dev, smi, tmp_dir, data)
    # the libreface path
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    with tempfile.TemporaryDirectory() as tmp_dir:
        phase_libreface(dev, smi, tmp_dir)
    k1l, k2l = warp_affine.launches, fused_bottleneck.launches
    k3_read("libreface")
    if k1l or k2l:
        raise AssertionError(f"libreface: K1/K2 launched {k1l}/{k2l} times")
    return {"warp_affine": {"app_file": k1a, "regen": k1r, "vox": k1v, "libreface": k1l},
            "fused_bottleneck": {"app_file": k2a, "regen": k2r, "vox": k2v, "libreface": k2l}}


# -- phases 30-34: the overlay, the annotator, the tile picker, multigrid, geo_jitter --

OVERLAY_HW, OVERLAY_FRAMES, OVERLAY_CLI_FRAMES = (720, 1280), 120, 32
VIZ_FRAMES, VIZ_CLI_FRAMES, VIZ_DET_SIZE = 24, 6, 320
TILE_HW, TILE_GUTTER, TILE_FRAMES = (1080, 1920), 4, 4
TILE_IOU = 0.98            # the picked rectangle against the tile drawn (edges eat ~1 px)
TILE_MIN_HITS = 3          # of TILE_FRAMES grids
MULTIGRID_ARGS = ["--steps_per_epoch", "2"]
# MultigridConfig()'s long-cycle shapes, (batch, T, S)
MULTIGRID_SHAPES = {(64, 8, 158), (32, 16, 158), (16, 16, 224), (8, 32, 224)}
GEO_ITEMS = 4


def run_overlay_app(scorer, frames, rows, out_video=None) -> dict:
    """``run_app_over``'s app and point, overlaid when ``out_video`` is
    given: each overlay kept (``on_frame``) and written; ``draw_overlay``'s
    wall time summed. K1's count zeroed just before the run, read after."""
    from stdd_torch.eval.synth_e2e import OracleDetector

    pipe = PipelineConfig(**ENGINE_PIPE)
    oracle = OracleDetector({"v": rows}, pipe.detect_every, 0.0).switch("v")
    eng = StreamingEngine(scorer, AsyncDetector(oracle), cfg=pipe, **ENGINE_KW)
    app = RealtimeApp(eng, threshold=pipe.threshold)
    t = {"overlay": 0.0}
    app.draw_overlay = TimedCall(app.draw_overlay, t, "overlay")
    overlays = []
    try:
        eng.warmup()
        seq0 = eng._group._next_seq
        # the run starts here
        warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0
        t0 = time.perf_counter()
        ready, fake = run_loop(app, iter(frames), out_video=out_video,
                               on_frame=overlays.append if out_video else None)
        dt = time.perf_counter() - t0
        launches, k2 = warp_affine.launches, fused_bottleneck.launches   # ... ends here
        k3n = k3.bias_act.launches
        batches = eng._group._next_seq - seq0
    finally:
        eng.close()
    return {"fps": app.frames_seen / dt, "frames_seen": app.frames_seen, "overlays": overlays,
            "overlay_ms": 1000.0 * t["overlay"] / max(1, len(overlays)),
            "scores": {int(k): [float(p) for p in v] for k, v in app.running_scores.items()},
            "ready": bool(ready), "fake": bool(fake), "k1_launches": launches, "k2_launches": k2,
            "k3_launches": k3n, "batches_dispatched": batches}


def phase_overlay(scorer, smi: str, tmp_dir: str, onnx: str):
    """The app with the overlay over a 720p ``.y4m`` of one face (120
    frames, oracle rows) at ``app``'s point: fps without and with the
    overlay written by ``--out_video``'s path, the overlay's ms a frame, K1
    = scored batches, the written file decoded against the in-memory
    overlays' ``.y4m`` round trip, the boxes drawn; then the CLI with
    ``--out_video``. → (K1, K2) launches of the overlay run."""
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.utils.video_io import read_y4m, write_y4m

    scene = BenchScene(OVERLAY_HW, n_faces=1, seed=SEED + 70, device=str(scorer.device))
    src = os.path.join(tmp_dir, "call.y4m")
    write_y4m(src, (scene.frame(i) for i in range(OVERLAY_FRAMES)))      # set-up
    frames = list(read_y4m(src))
    rows = oracle_rows(scene, OVERLAY_FRAMES)
    plain = run_overlay_app(scorer, frames, rows)
    out = os.path.join(tmp_dir, "overlay.y4m")
    ov = run_overlay_app(scorer, frames, rows, out_video=out)
    k3_read("overlay", ov["k3_launches"])
    ref = os.path.join(tmp_dir, "overlay_ref.y4m")
    write_y4m(ref, ov["overlays"])
    got = list(read_y4m(out))
    diff = max((int(np.abs(g.astype(int) - w).max()) for g, w in zip(got, read_y4m(ref))),
               default=-1)
    green_red = [np.array([0, 255, 0]), np.array([0, 0, 255])]
    boxed = sum(bool(any(((o == c).all(-1) & ~(f == c).all(-1)).sum() > 100 for c in green_red))
                for o, f in zip(ov["overlays"], frames))
    cli_out = os.path.join(tmp_dir, "cli_overlay.y4m")
    cmd = [sys.executable, "-m", "stdd_torch.runtime.app", "--source", src, "--max_frames",
           str(OVERLAY_CLI_FRAMES), "--det_model", onnx, "--no_warmup", "--out_video", cli_out]
    t0 = time.perf_counter()
    cli = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    cli_frames = sum(1 for _ in read_y4m(cli_out)) if os.path.isfile(cli_out) else 0
    r = {"phase": "overlay", "card": smi, "frame_hw": list(OVERLAY_HW), "frames": OVERLAY_FRAMES,
         "detector": "BenchScene.oracle rows", "detections_real": False,
         "fps_without_overlay": plain["fps"], "fps_with_overlay": ov["fps"],
         "overlay_ms_per_frame": ov["overlay_ms"], "frames_written": len(got),
         "file_vs_memory_max_diff": diff, "frames_with_box_drawn": boxed,
         "k1_launches": ov["k1_launches"], "batches_dispatched": ov["batches_dispatched"],
         "k2_launches": ov["k2_launches"], "scored_tracks": ov["scores"],
         "scores_equal_without_overlay": ov["scores"] == plain["scores"],
         "meeting_ready": ov["ready"], "meeting_fake": ov["fake"],
         "cli_rc": cli.returncode, "cli_seconds": cli_s, "cli_frames_written": cli_frames}
    emit(r)
    flat = [p for v in ov["scores"].values() for p in v]
    if not (ov["k1_launches"] == ov["batches_dispatched"] > 0 and not ov["k2_launches"] and flat
            and np.isfinite(flat).all() and ov["frames_seen"] == OVERLAY_FRAMES):
        raise AssertionError(f"overlay: K1 {ov['k1_launches']}, batches "
                             f"{ov['batches_dispatched']}, scores {ov['scores']}")
    if not (len(got) == OVERLAY_FRAMES and diff == 0 and boxed > OVERLAY_FRAMES // 2):
        raise AssertionError(f"overlay: {len(got)} frames written, file vs memory {diff}, "
                             f"{boxed} frames with a box")
    if cli.returncode != 0 or cli_frames != OVERLAY_CLI_FRAMES:
        raise AssertionError(f"overlay: the CLI exited {cli.returncode} with {cli_frames} "
                             f"frames written: {cli.stderr[-2000:]}")
    return ov["k1_launches"], ov["k2_launches"], scene


def phase_viz(dev, smi: str, tmp_dir: str, onnx: str, scene):
    """``visualize_detections``, ByteTracker + ``visualize_tracks`` and the
    packaged landmarker + ``draw_dense_landmarks`` on the overlay scene's
    720p frames and oracle rows, the landmarker on the card: ms a frame of
    each; then the CLI over a ``.y4m`` (``--track --dense_landmarks``) and
    a PNG, on the YuNet-shaped random graph."""
    from stdd_torch.eval.viz import draw_dense_landmarks, visualize_detections, visualize_tracks
    from stdd_torch.models.facemesh import DenseLandmarker
    from stdd_torch.track.byte_tracker import ByteTracker
    from stdd_torch.utils.image_io import imwrite
    from stdd_torch.utils.video_io import read_y4m, write_y4m

    frames = [scene.frame(i) for i in range(VIZ_FRAMES)]                  # set-up
    rows = oracle_rows(scene, VIZ_FRAMES)
    lm = DenseLandmarker.pretrained(device=dev)
    tracker = ByteTracker(track_thresh=0.5, match_thresh=0.8, track_buffer=30,
                          split_low_scores=False)
    t = {"detections": 0.0, "tracks": 0.0, "landmarker": 0.0, "dense_draw": 0.0}
    drawn = 0
    for f, r in zip(frames, rows):
        t0 = time.perf_counter()
        a = visualize_detections(f, r)
        t1 = time.perf_counter()
        tlbr = np.stack([r[:, 0], r[:, 1], r[:, 0] + r[:, 2], r[:, 1] + r[:, 3], r[:, 14]], 1)
        b = visualize_tracks(f, tracker.update(tlbr))
        t2 = time.perf_counter()
        pts = [lm(f[:, :, ::-1], (x, y, x + w, y + h)) for x, y, w, h in r[:, :4]]
        t3 = time.perf_counter()
        for p in pts:
            draw_dense_landmarks(b, p, copy=False)
        t4 = time.perf_counter()
        for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            t[k] += dt
        drawn += int((a != f).any()) + int((b != f).any())
    ms = {k: 1000.0 * v / VIZ_FRAMES for k, v in t.items()}
    src, png = os.path.join(tmp_dir, "viz.y4m"), os.path.join(tmp_dir, "viz.png")
    write_y4m(src, frames[:VIZ_CLI_FRAMES])
    imwrite(png, frames[0])
    clis = {}
    for name, inp, extra in (("y4m", src, ["--track", "--dense_landmarks"]), ("png", png, [])):
        out = os.path.join(tmp_dir, f"viz_out.{name}")
        cmd = [sys.executable, "-m", "stdd_torch.eval.viz", "--input", inp, "--output", out,
               "--det_model", onnx, "--det_size", str(VIZ_DET_SIZE)] + extra
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        clis[name] = {"rc": res.returncode, "seconds": time.perf_counter() - t0,
                      "written": os.path.isfile(out) and os.path.getsize(out) > 0,
                      "stdout": res.stdout.strip().splitlines()[-1:], "stderr": res.stderr[-1500:]}
    clis["y4m"]["frames"] = sum(1 for _ in read_y4m(os.path.join(tmp_dir, "viz_out.y4m"))) \
        if clis["y4m"]["written"] else 0
    r = {"phase": "viz", "card": smi, "frame_hw": list(OVERLAY_HW), "frames": VIZ_FRAMES,
         "detector": "BenchScene.oracle rows", "detections_real": False,
         "ms_per_frame": ms, "landmarker_share": ms["landmarker"] / sum(ms.values()),
         "frames_drawn": drawn,
         "cli": {k: {kk: vv for kk, vv in v.items() if kk != "stderr"} for k, v in clis.items()},
         "cli_detector": "YuNet-shaped random graph"}
    emit(r)
    if drawn != 2 * VIZ_FRAMES:
        raise AssertionError(f"viz: {drawn} of {2 * VIZ_FRAMES} annotated frames changed")
    for name, c in clis.items():
        if c["rc"] != 0 or not c["written"]:
            raise AssertionError(f"viz: the CLI on the {name} exited {c['rc']}: {c['stderr']}")
    if clis["y4m"]["frames"] != VIZ_CLI_FRAMES:
        raise AssertionError(f"viz: the CLI wrote {clis['y4m']['frames']} frames")


def call_grid(seed: int, dev):
    """A 1080p 2×2 call grid: four ``BenchScene`` tiles between thin
    gutters reaching the frame's edges (a gallery view). → (frame, tiles as
    (x1, y1, x2, y2))."""
    from stdd_torch.eval.bench_scene import BenchScene

    H, W = TILE_HW
    g = TILE_GUTTER
    h, w = H // 2 - g // 2, W // 2 - g // 2
    frame = np.full((H, W, 3), 16, np.uint8)
    tiles = []
    for i, (y, x) in enumerate(((0, 0), (0, W // 2 + g // 2), (H // 2 + g // 2, 0),
                                (H // 2 + g // 2, W // 2 + g // 2))):
        frame[y:y + h, x:x + w] = BenchScene((h, w), n_faces=1, seed=seed + i,
                                             device=str(dev)).frame(0)
        tiles.append((x, y, x + w, y + h))
    return frame, tiles


def iou(a, b) -> float:
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)


def phase_tile(dev, smi: str):
    """``LargestTilePicker.pick`` (host numpy) on 1080p 2×2 call grids and
    on frames with no tile (noise: the first has no motion reference, the
    next fall back on motion): the picked rectangle against the tile drawn,
    and ms a frame."""
    from stdd_torch.runtime.sources import LargestTilePicker

    grids = [call_grid(SEED + 80 + 4 * k, dev) for k in range(TILE_FRAMES)]  # set-up
    noise = [np.random.RandomState(SEED + k).randint(0, 256, TILE_HW + (3,)).astype(np.uint8)
             for k in range(2)]
    picker = LargestTilePicker()
    picks, ms = [], []
    for frame, tiles in grids:
        t0 = time.perf_counter()
        r = picker.pick(frame)
        ms.append(1000.0 * (time.perf_counter() - t0))
        picks.append({"rect": list(r), "best_iou": max(iou(r, t) for t in tiles),
                      "tile": int(np.argmax([iou(r, t) for t in tiles]))})
    no_tile = []
    fresh = LargestTilePicker()
    for f in noise:
        t0 = time.perf_counter()
        no_tile.append(list(fresh.pick(f)))
        ms.append(1000.0 * (time.perf_counter() - t0))
    H, W = TILE_HW
    r = {"phase": "tile", "card": smi, "frame_hw": list(TILE_HW), "gutter_px": TILE_GUTTER,
         "grid_picks": picks, "tile_hits": sum(p["best_iou"] >= TILE_IOU for p in picks), "no_tile_picks": no_tile, "ms_per_frame": ms,
         "ms_median": float(np.median(ms)), "device": "host (numpy)"}
    emit(r)
    # the JAX heuristic (ported as it is) can leak through a stretch of
    # gutter where a tile's content is as dark as the gutter: such a pick is
    # recorded; most picks must be a drawn tile
    if sum(p["best_iou"] >= TILE_IOU for p in picks) < TILE_MIN_HITS:
        raise AssertionError(f"tile: picks {picks}: fewer than {TILE_MIN_HITS} of "
                             f"{len(picks)} are a drawn tile (IoU ≥ {TILE_IOU})")
    if no_tile[0] != [0, 0, W, H] or no_tile[1] == [0, 0, W, H]:
        raise AssertionError(f"tile: frames with no tile picked {no_tile}")


def phase_multigrid(smi: str):
    """``python -m stdd_torch.train.measure_multigrid --steps_per_epoch 2``
    in this process: the production schedule at 32×224² bf16."""
    from stdd_torch.train import measure_multigrid

    t0 = time.perf_counter()
    rec = measure_multigrid.main(MULTIGRID_ARGS)
    emit({"phase": "multigrid", "card": smi, "seconds": time.perf_counter() - t0,
          "args": MULTIGRID_ARGS, "record": "the multigrid_long_cycle_epoch line above"})
    shapes = {tuple(s["shape"]) for s in rec["shapes"]}
    if not (rec["losses_finite"] and rec["resume_drill"] and rec["resume_drill"]["bitwise_identical"]
            and shapes == MULTIGRID_SHAPES and rec["precise_bn_stem_moved"] > 0
            and 0.0 <= rec["eval_auc_after_precise_bn"] <= 1.0):
        raise AssertionError(f"multigrid: {rec}")


def phase_geo_jitter(dev, smi: str, tmp_dir: str):
    """``I3DClipDataset`` items at ``geo_jitter`` 1.0 and 0 on a 32×224²
    clip tree (the host's seconds an item), then one ``run_i3d``-shaped
    step (I3D-R50 bf16, batch 8, ImageNet-normalized) on jittered clips."""
    from stdd_torch.data.dataset_i3d import I3DClipDataset
    from stdd_torch.models.i3d import I3D, IMAGENET_MEAN, IMAGENET_STD
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training

    root = os.path.join(tmp_dir, "clips")
    write_clip_tree(root, np.random.RandomState(SEED + 90))                 # set-up
    secs = {}
    for g in (1.0, 0.0):
        ds = I3DClipDataset(root_dir=root, T=TRAIN_T, is_train=True, seed=SEED, geo_jitter=g)
        t0 = time.perf_counter()
        for i in range(GEO_ITEMS):
            ds[i]
        secs[g] = (time.perf_counter() - t0) / GEO_ITEMS
    ds = I3DClipDataset(root_dir=root, T=TRAIN_T, is_train=True, seed=SEED, geo_jitter=1.0)
    clips, ys = next(ds.batches(8, seed=SEED))
    model = I3D(I3DConfig(num_frames=TRAIN_T, crop_size=TRAIN_S), dtype=torch.bfloat16).to(dev)
    state, step_fn, _ = init_i3d_training(model, I3DTrainArgs(steps_per_epoch=1, max_epoch=1))
    mean, std = (torch.as_tensor(a, device=dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
    x = (torch.from_numpy(clips).to(dev).float() - mean) / std
    # the geo_jitter path
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, x, torch.from_numpy(ys).to(dev), SEED)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    k1, k2, k3n = warp_affine.launches, fused_bottleneck.launches, k3_read("geo_jitter")
    r = {"phase": "geo_jitter", "card": smi, "clip": [TRAIN_T, TRAIN_S, TRAIN_S],
         "host_s_per_item_geo_1": secs[1.0], "host_s_per_item_geo_0": secs[0.0],
         "geo_share_of_item": 1.0 - secs[0.0] / secs[1.0], "batch": len(ys),
         "step_loss": loss, "first_step_s": step_s, "k1_launches": k1, "k2_launches": k2,
         "k3_launches": k3n}
    emit(r)
    if not (np.isfinite(loss) and clips.shape == (8, TRAIN_T, TRAIN_S, TRAIN_S, 3)):
        raise AssertionError(f"geo_jitter: loss {loss}, clips {clips.shape}")
    if k3n:
        raise AssertionError(f"geo_jitter: K3 launched {k3n} times in a training step")
    return k1, k2


def phase_slice13(dev, smi: str, scorer) -> dict:
    """Phases 30-34; → {kernel: {phase: launches}} (K1 and K2 are counted
    from zero just before each path and read just after)."""
    launches = {"warp_affine": {}, "fused_bottleneck": {}}

    def count(name, fn):
        warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0
        fn()
        launches["warp_affine"][name] = warp_affine.launches
        launches["fused_bottleneck"][name] = fused_bottleneck.launches
        k3_read(name)
        if warp_affine.launches or fused_bottleneck.launches:
            raise AssertionError(f"{name}: K1/K2 launched {warp_affine.launches}/"
                                 f"{fused_bottleneck.launches} times")

    with tempfile.TemporaryDirectory() as tmp_dir:
        onnx = write_onnx(yunet_shaped_graph(SEED), os.path.join(tmp_dir, "yunet_shaped.onnx"))
        k1o, k2o, scene = phase_overlay(scorer, smi, tmp_dir, onnx)
        launches["warp_affine"]["overlay"], launches["fused_bottleneck"]["overlay"] = k1o, k2o
        count("viz", lambda: phase_viz(dev, smi, tmp_dir, onnx, scene))
    count("tile", lambda: phase_tile(dev, smi))
    count("multigrid", lambda: phase_multigrid(smi))
    with tempfile.TemporaryDirectory() as tmp_dir:
        k1g, k2g = phase_geo_jitter(dev, smi, tmp_dir)
    launches["warp_affine"]["geo_jitter"], launches["fused_bottleneck"]["geo_jitter"] = k1g, k2g
    if k1g or k2g:
        raise AssertionError(f"geo_jitter: K1/K2 launched {k1g}/{k2g} times")
    return launches



# -- phases 35-37: the FTCN trained, a temporal-only I3D served, the model zoo ----

FTCN_ARGS = ["--ftcn", "--batch", "8", "--epochs", "1", "--alter_freq", "2",
             "--base_lr", "0.01", "--warmup_epochs", "0.5", "--val_ratio", "0.15"]
FTCN_TIMED_STEPS = 10
FTCN_SERVE_BATCHES = 12
FTCN_SERVE_TOL = 1e-4        # float32 probs, card vs CPU: convolution sums in another order
# the zoo's float32 forward, card vs CPU (TF32 off), over max(1, max |CPU|):
# float32 convolution and matmul sums in another order through up to 50
# layers of random weights
ZOO_F32_TOL = 1e-3
ZOO_3D = dict(num_frames=32, crop_size=224)          # the published clip
ZOO_SMALL_3D = dict(num_frames=8, crop_size=64)
ZOO_VIT = dict(image_size=224, patch_size=16, num_frames=32)
ZOO_SMALL_VIT = dict(image_size=64, patch_size=16, num_frames=8)
ZOO_SCRFD_SIZE = 640
ZOO_TIMED = 3                # bf16 forwards timed a model (CUDA events; the median is kept)


def timed_steps(step, st, x, y, n: int):
    """CUDA-event ms of ``n`` steps (after two warm-up steps) and the peak
    memory; → (ms array, peak bytes, state)."""
    for _ in range(2):
        st, _ = step(st, x, y, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(n)]
    for a, b in evs:
        a.record()
        st, _ = step(st, x, y, SEED)
        b.record()
    torch.cuda.synchronize()
    return np.array([a.elapsed_time(b) for a, b in evs]), torch.cuda.max_memory_allocated(), st


def phase_ftcn_train(dev, smi: str, tmp_dir: str) -> str:
    """``python -m stdd_torch.train.run_i3d --ftcn`` in this process on the
    train phase's synthetic tree at full width (FTCN, stop_point 5, 32×224²,
    bf16, batch 8) for one epoch; the step's device time and peak memory
    on a fixed batch; a float32 step card vs CPU (8×64², batch 2);
    → the checkpoint."""
    from stdd_torch.data.dataset_i3d import I3DClipDataset
    from stdd_torch.models.ftcn import FTCN
    from stdd_torch.models.i3d import IMAGENET_MEAN, IMAGENET_STD
    from stdd_torch.train import run_i3d
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training

    tree, out = os.path.join(tmp_dir, "clips"), os.path.join(tmp_dir, "ftcn_run")
    write_clip_tree(tree, np.random.RandomState(SEED + 7))      # set-up, not timed
    t0 = time.perf_counter()
    state = run_i3d.main(["--data", tree, "--out", out, "--clip_size", str(TRAIN_T),
                          "--crop_size", str(TRAIN_S), *FTCN_ARGS, "--device", str(dev)])
    seconds = time.perf_counter() - t0
    ckpt = os.path.join(out, "i3d_1.msgpack")
    with open(ckpt + ".json") as f:
        sidecar = json.load(f)
    stats, _ = read_train_log(os.path.join(out, "log.txt"))
    losses = [r["loss"] for r in stats if r["_type"] == "train_epoch"]

    cfg = I3DConfig(num_frames=TRAIN_T, crop_size=TRAIN_S, temporal_only=True)
    model = FTCN(cfg, dtype=torch.bfloat16).to(dev)
    st, step, _ = init_i3d_training(model, I3DTrainArgs(
        base_lr=0.01, max_epoch=1, warmup_epochs=0.5, warmup_start_lr=0.0025, alter_freq=2,
        steps_per_epoch=state.step, grad_clip=1.0))
    st = run_i3d.load_train_checkpoint(ckpt, model, st)
    ds = I3DClipDataset(root_dir=tree, T=TRAIN_T, is_train=True, seed=SEED)
    clips, ys = next(ds.batches(8, seed=SEED))
    mean, std = (torch.as_tensor(a, device=dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
    x = (torch.from_numpy(clips).to(dev).float() - mean) / std
    step_ms, peak, st = timed_steps(step, st, x, torch.from_numpy(ys).to(dev), FTCN_TIMED_STEPS)
    del model, st, x
    torch.cuda.empty_cache()
    f32 = train_f32_card_vs_cpu(dev, ftcn=True)
    r = {"phase": "ftcn_train", "card": smi, "model": "FTCN (ftcn_tt: temporal-only, stop_point 5)",
         "clip": TRAIN_T, "crop": TRAIN_S, "batch": 8, "dtype": "bfloat16 compute, float32 weights",
         "steps": state.step, "epoch_loss": losses, "seconds_one_epoch": seconds,
         "sidecar": sidecar, "step_ms_median": float(np.median(step_ms)),
         "step_ms_p90": float(np.percentile(step_ms, 90)),
         "clips_per_s": 8 * 1000.0 / float(np.median(step_ms)),
         "max_memory_allocated_gib": peak / 2 ** 30, "f32_card_vs_cpu": f32,
         "tol": TRAIN_F32_TOLS}
    emit(r)
    if not (losses and np.isfinite(losses).all()):
        raise AssertionError(f"ftcn_train: epoch losses {losses}")
    if sidecar.get("temporal_only") is not True:
        raise AssertionError(f"ftcn_train: the sidecar {sidecar} does not say temporal_only")
    for key, tol in TRAIN_F32_TOLS.items():
        if not f32[key] <= tol:
            raise AssertionError(f"ftcn_train: float32 card vs CPU {key} {f32[key]} > {tol}")
    return ckpt


def phase_ftcn_serve(dev, smi: str, tmp_dir: str, ftcn_ckpt: str):
    """A temporal-only I3D checkpoint (random weights, full width, the
    trainer's ``temporal_only`` sidecar) served by ``ClipScorer`` at
    32×224² bf16 with ``fused_s2`` on, over I420 ring windows: K1 once a
    batch, K2 never; ms a batch; float32 probs card vs CPU; and the
    ``--ftcn`` checkpoint refused as JAX's loader refuses it; → K1, K2
    launches."""
    from stdd_torch.models.i3d import I3D
    from stdd_torch.runtime.classifier import sidecar_config

    cfg = I3DConfig(temporal_only=True)
    model = I3D(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    randomize_bn(model, SEED)
    path = save_checkpoint(tmp_dir, "temporal", 1, i3d_torch_to_flax(model.state_dict()),
                           metadata={"crop_size": cfg.crop_size, "clip_size": cfg.num_frames,
                                     "temporal_only": True, "epoch": 1})
    served = dataclasses.replace(sidecar_config(path), fused_s2=True)
    scorer = ClipScorer.from_jax_checkpoint(path, cfg=served, upload_format="yuv420", device=dev)
    scorer32 = ClipScorer.from_jax_checkpoint(path, cfg=served, dtype=torch.float32,
                                              upload_format="yuv420", device=dev)
    cpu32 = ClipScorer.from_jax_checkpoint(path, cfg=served, dtype=torch.float32,
                                           upload_format="yuv420", device="cpu")
    rng = np.random.RandomState(SEED + 40)
    T, S, B = cfg.num_frames, 256, 2
    host_ws = clip_windows(rng, B, T, S)
    ws = [torch.from_numpy(w).to(dev) for w in host_ws]
    geo = [clip_geometry(rng, T) for _ in range(B)]
    boxes, lm5, scale = (np.stack([g[i] for g in geo]) for i in range(3))
    valid = np.ones((B,), bool)
    np.asarray(scorer.score_windows(ws, boxes, lm5, scale, valid))     # warm-up
    torch.cuda.synchronize()
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0  # the serving path
    times = []
    for _ in range(FTCN_SERVE_BATCHES):
        t0 = time.perf_counter()
        p16 = np.asarray(scorer.score_windows(ws, boxes, lm5, scale, valid))
        times.append((time.perf_counter() - t0) * 1000)
    k1, k2, k3n = warp_affine.launches, fused_bottleneck.launches, k3_read("ftcn_serve")
    p32 = np.asarray(scorer32.score_windows(ws, boxes, lm5, scale, valid))
    pcpu = np.asarray(cpu32.score_windows([torch.from_numpy(w) for w in host_ws], boxes, lm5,
                                          scale, valid))
    fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
    try:
        ClipScorer.from_jax_checkpoint(ftcn_ckpt, device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)[:160]
    r = {"phase": "ftcn_serve", "card": smi, "model": "I3D-R50 temporal_only, stop_point 5",
         "clip": T, "crop": cfg.crop_size, "batch": B, "dtype": "bfloat16", "fused_s2": True,
         "batches": FTCN_SERVE_BATCHES, "k1_launches": k1, "k2_launches": k2,
         "k3_launches": k3n,
         "ms_per_batch_median": float(np.median(times)), "ms_per_batch_p90": float(np.percentile(times, 90)),
         "probs_bf16": p16.tolist(), "probs_f32": p32.tolist(),
         "f32_card_vs_cpu_dp": float(np.abs(p32 - pcpu).max()),
         "bf16_vs_f32_dp": float(np.abs(p16 - p32).max()), "tol": FTCN_SERVE_TOL,
         "ftcn_checkpoint_refused": refused}
    emit(r)
    if not (np.isfinite(p16).all() and ((p16 > 0) & (p16 < 1)).all()):
        raise AssertionError(f"ftcn_serve: probs {p16}")
    if k1 != FTCN_SERVE_BATCHES or k2:
        raise AssertionError(f"ftcn_serve: K1/K2 launched {k1}/{k2} times in "
                             f"{FTCN_SERVE_BATCHES} batches (want {FTCN_SERVE_BATCHES}/0)")
    if not r["f32_card_vs_cpu_dp"] <= FTCN_SERVE_TOL:
        raise AssertionError(f"ftcn_serve: float32 card vs CPU {r['f32_card_vs_cpu_dp']}")
    if not (refused and "does not cover the model" in refused):
        raise AssertionError(f"ftcn_serve: the --ftcn checkpoint was not refused: {refused}")
    return k1, k2


def zoo_inputs(name: str, small: bool, gen):
    """(build kwargs, input) for a registry name: the 3D nets at
    ``ZOO_3D`` (or ``ZOO_SMALL_3D``), the transformers at ``ZOO_VIT``, the
    2D ResNet on 224² frames (64²); batch 1 (2 for the small ones)."""
    B = 2 if small else 1
    if name in ("videoit", "st_transformer"):
        kw = ZOO_SMALL_VIT if small else ZOO_VIT
        return dict(kw), torch.randn(B, kw["num_frames"], kw["image_size"], kw["image_size"], 3,
                                     generator=gen)
    if name == "resnet2d":
        S = 64 if small else 224
        return {"variant": "resnet18"}, torch.randn(B, S, S, 3, generator=gen)
    c = ZOO_SMALL_3D if small else ZOO_3D
    return {"cfg": I3DConfig(**c)}, torch.randn(B, c["num_frames"], c["crop_size"],
                                                 c["crop_size"], 3, generator=gen)


def zoo_forward(model, x, bf16: bool):
    """One eval forward; the outputs as float32 tensors. The transformers
    (float32 modules, as in JAX) run under autocast in bf16."""
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16 and
                                                not hasattr(model, "compute_dtype")):
        out = model(x)
    return [t.float() for t in (out if isinstance(out, tuple) else (out,))]


def phase_zoo(dev, smi: str, tmp_dir: str):
    """Every registry name at its published width on the card: one bf16
    eval forward (ms, peak memory) and a float32 forward at a small input
    on the card against the CPU (``ZOO_F32_TOL``); RetinaFace and SCRFD
    (random weights, ``detections_real: false``) on one rendered 720p
    ``BenchScene`` frame."""
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.models import MODEL_REGISTRY, build_model
    from stdd_torch.models.retinaface import RetinaFaceDetector
    from stdd_torch.models.scrfd import SCRFDDetector
    from stdd_torch.utils.onnx_writer import scrfd_shaped_graph

    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for name in sorted(MODEL_REGISTRY):
        kw, x = zoo_inputs(name, False, gen)
        bf = {"dtype": torch.bfloat16} if name not in ("videoit", "st_transformer") else {}
        with torch.device(dev):
            model = build_model(name, **kw, **bf).eval()
        x = x.to(dev)
        zoo_forward(model, x, True)                                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(ZOO_TIMED):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out16 = zoo_forward(model, x, True)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in model.parameters())
        bf16_input = list(x.shape)
        del model, x
        kw, xs = zoo_inputs(name, True, gen)
        with torch.device(dev):
            m32 = build_model(name, **kw).eval()
        cpu = build_model(name, **kw).eval()
        cpu.load_state_dict({k: v.cpu() for k, v in m32.state_dict().items()})
        got = zoo_forward(m32, xs.to(dev), False)
        want = zoo_forward(cpu, xs, False)
        err = max(float((g.cpu() - w).abs().max()) / max(1.0, float(w.abs().max()))
                  for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(t).all()) for t in out16)
        rows.append({"name": name, "params_m": n_params / 1e6, "bf16_input": bf16_input,
                     "f32_input": list(xs.shape), "bf16_ms_median": float(np.median(ms)),
                     "bf16_ms": ms, "bf16_peak_gib": peak / 2 ** 30,
                     "out_shape": [list(t.shape) for t in out16], "bf16_finite": finite,
                     "f32_card_vs_cpu": err})
        del m32, cpu
        torch.cuda.empty_cache()
    scene = BenchScene((720, 1280), n_faces=1, seed=SEED, device=dev)
    frame = scene.frame(0, copy=True)
    det = RetinaFaceDetector.random_init((720, 1280), seed=SEED, device=dev)
    det.detect(frame)                                                  # warm-up
    t0 = time.perf_counter()
    dets, mask = det.detect(frame)
    rf = {"ms": (time.perf_counter() - t0) * 1000, "detections": int(mask.sum())}
    onnx = write_onnx(scrfd_shaped_graph(SEED), os.path.join(tmp_dir, "scrfd_shaped.onnx"))
    sd = SCRFDDetector(onnx, input_size=(ZOO_SCRFD_SIZE, ZOO_SCRFD_SIZE), device=dev)
    small = resize_linear_u8(torch.from_numpy(frame).to(dev), ZOO_SCRFD_SIZE, ZOO_SCRFD_SIZE)
    sd.detect(small)                                                   # warm-up
    t0 = time.perf_counter()
    sdets, smask = sd.detect(small)
    sc = {"ms": (time.perf_counter() - t0) * 1000, "detections": int(smask.sum()),
          "input": [ZOO_SCRFD_SIZE, ZOO_SCRFD_SIZE]}
    emit({"phase": "zoo", "card": smi, "models": rows, "f32_tol": ZOO_F32_TOL,
          "retinaface_720p": rf, "scrfd_720p": sc, "weights": "random",
          "detections_real": False})
    for r in rows:
        if not (r["bf16_finite"] and r["f32_card_vs_cpu"] <= ZOO_F32_TOL):
            raise AssertionError(f"zoo: {r}")
    for d, m in ((dets, mask), (sdets, smask)):
        if not np.isfinite(d[m]).all():
            raise AssertionError("zoo: a detector gave non-finite rows")


def phase_slice14(dev, smi: str) -> dict:
    """Phases 35-37; → {kernel: {phase: launches}} (counted from zero just
    before each path and read just after)."""
    launches = {"warp_affine": {}, "fused_bottleneck": {}}
    with tempfile.TemporaryDirectory() as tmp_dir:
        fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
        ckpt = phase_ftcn_train(dev, smi, tmp_dir)
        launches["warp_affine"]["ftcn_train"] = warp_affine.launches
        launches["fused_bottleneck"]["ftcn_train"] = fused_bottleneck.launches
        k3_read("ftcn_train")
        k1, k2 = phase_ftcn_serve(dev, smi, tmp_dir, ckpt)
        launches["warp_affine"]["ftcn_serve"], launches["fused_bottleneck"]["ftcn_serve"] = k1, k2
        fused_bottleneck.launches = warp_affine.launches = k3.bias_act.launches = 0
        phase_zoo(dev, smi, tmp_dir)
        launches["warp_affine"]["zoo"] = warp_affine.launches
        launches["fused_bottleneck"]["zoo"] = fused_bottleneck.launches
        k3_read("zoo")
    for name in ("ftcn_train", "zoo"):
        if launches["warp_affine"][name] or launches["fused_bottleneck"][name]:
            raise AssertionError(f"{name}: K1/K2 launched on a path that has none")
    return launches



# -- phases 38-39: data parallel and int8 -----------------------------------------
# the mesh run (world 1 over NCCL) against the plain run: the same step but
# for the gradient's all-reduce over one rank, so their epoch losses differ
# only by cuDNN's nondeterministic bf16 sums (2.5e-5 of max(1, |loss|) at
# most over the sound runs on the H100, PERF.md): 1e-3 is some 40× that;
# two ranks on one card (gloo carrying CUDA tensors) against one, float32,
# TF32 off: TRAIN_F32_TOLS' 1e-5
DDP_LOSS_TOL = 1e-3
DDP_WORLD_TOL = 1e-5
DDP_TIMED_STEPS = 10
DDP_PAIR_CFG = dict(num_frames=4, crop_size=32, width_per_group=16)      # reduced width
# the dual pair: a step at world 2 against world 1 on the card, TF32 off
# (each rank's encoders run half the batch: GEMMs of other shapes may sum in
# another order). Parts over max(1, |world 1|); Adam's moments after the
# step (mu the clipped gradients' trace, nu their squares) over their
# largest entry; the parameters over max(1, |world 1|). In float64 all
# within 1e-10, the CPU test's WORLD_TOL (≤ 4.4e-14 on an H100): there a
# gradient that is zero but for rounding lies far under Adam's eps, so the
# parameters show an update left out, of the wrong sign or wrongly masked.
# In float32 the parts within 1e-5 (1.6e-6 at most on an H100, the grad
# norm); the moments within DUAL_F32_TOLS' 1e-4 and 2e-4 (8.5e-6 and 1.5e-5
# on an H100: the gradients cancel, so a float32 sum in another order moves
# the largest of them by about 70 of float32's eps); the parameters within
# DUAL_F32_TOLS' 2.5e-5 (5.0e-6 on an H100): a first Adam step moves each by
# up to the one-cycle's first LR (1.2e-5) whatever its gradient's size, so a
# gradient that is zero but for rounding may step either way.
DDP_DUAL_TOLS = {"float32": {"parts": 1e-5, **{k: DUAL_F32_TOLS[k] for k in ("mu", "nu", "params")}},
                 "float64": {"parts": 1e-10, "mu": 1e-10, "nu": 1e-10, "params": 1e-10}}
DDP_DUAL_BATCH = 16          # the global batch, 8 a rank
DDP_DUAL_T = 8               # run_dual's --T
DDP_DUAL_DOMAINS = 5         # the dual phase's tree: a real class and four techniques
INT8_BATCHES = (2, 8)
INT8_TIMED = 10              # scored batches timed a configuration and round
# float32 int8 probs, card vs CPU (8×64²): a float32 sum in another order can
# put an activation on the other side of a half and move its integer by one
# (tests/test_torch_int8.py bounds the port against JAX's the same way)
INT8_F32_TOL = 1e-3
# bf16 int8 against bf16 float probs on these seeded random weights: the
# quantization's shift, 3.7e-4 at most over the sound runs on the H100
# (PERF.md); the probs sit within about 0.01 of 0.49, so the bound is 2e-3
# (JAX's envelope of 0.05 in tests/test_int8.py would pass a wrong scale)
INT8_DP_TOL = 2e-3
INT8_APP_FRAMES = 120


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _ddp_pair(device: str) -> dict:
    """One rank of two on the one card (gloo carrying CUDA tensors): a
    float32 I3D step at world 2 and at world 1 from the same weights and
    global batch; returns what it saw."""
    import torch.distributed as dist

    from stdd_torch.models.i3d import I3D
    from stdd_torch.parallel.mesh import COLLECTIVES, DataParallel, local_rows
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training

    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.RandomState(SEED + 70)
    x = torch.from_numpy(rng.randn(4, 4, 32, 32, 3).astype(np.float32)).to(dev)
    y = torch.tensor([0.0, 1.0, 1.0, 0.0], device=dev)
    res = {}
    for w, dp in ((1, None), (world, DataParallel(rank, world))):
        model = I3D(I3DConfig(**DDP_PAIR_CFG)).to(dev)
        args = I3DTrainArgs(base_lr=0.01, max_epoch=1, warmup_epochs=0.5,
                            warmup_start_lr=0.0025, alter_freq=2, steps_per_epoch=4, grad_clip=1.0)
        st, step, _ = init_i3d_training(model, args, dp=dp)
        xs, ys = (x, y) if dp is None else (local_rows(x, rank, w), local_rows(y, rank, w))
        _sync(dev)
        t0 = time.perf_counter()
        st, m = step(st, xs, ys, SEED)
        _sync(dev)
        res[w] = {"loss": float(m["loss"]), "seconds": time.perf_counter() - t0,
                  "state": {k: v.double().cpu() for k, v in model.state_dict().items()}}
    res["collectives_step"] = dict(COLLECTIVES)
    res["backend"] = dist.get_backend()
    res["dual"] = _ddp_dual_pair(dev, rank, world)
    return res


def _ddp_dual_pair(dev, rank: int, world: int) -> dict:
    """A step of the shipped dual model (``dual_setup``: run_dual's
    defaults, dropout on) with ``DualTrainArgs``' SLERP and DAT at λ 0.1,
    at world 1 and at ``world`` from the same weights, global batch and
    seed, each timed after an untimed step of its own, in float32 and in
    float64; ``dom_id`` holds an invalid id. → {dtype: {world: its
    seconds, parts, parameters, Adam's moments and collectives}}."""
    from stdd_torch.parallel.mesh import COLLECTIVES, DataParallel, local_rows

    rng = np.random.RandomState(SEED + 71)
    B = DDP_DUAL_BATCH
    y = (np.arange(B) % 2).astype(np.float32)
    dom_id = (y * (1 + np.arange(B) % (DDP_DUAL_DOMAINS - 1))).astype(np.int64)
    dom_id[3] = -1
    T = DDP_DUAL_T
    data = {"A": rng.randn(B, T, 36).astype(np.float32),
            "L": rng.randn(B, T, 132).astype(np.float32), "y": y,
            "lengths": np.where(np.arange(B) % 5 == 0, T // 2, T).astype(np.int64),
            "dom_id": dom_id}
    out = {}
    for dtype in (torch.float32, torch.float64):
        out[str(dtype)[6:]] = res = {}
        for w, dp in ((1, None), (world, DataParallel(rank, world))):
            batch = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in dual_batch(data, np.arange(B), dev).items()}
            if dp is not None:
                batch = local_rows(batch, rank, w)
            _, state, step, mask = dual_setup(dev, DDP_DUAL_DOMAINS, dp=dp, dtype=dtype)
            step(state, batch, mask, 0.1, SEED)             # warm-up: cuBLAS's set-up
            _, state, step, mask = dual_setup(dev, DDP_DUAL_DOMAINS, dp=dp, dtype=dtype)
            COLLECTIVES.clear()
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch, mask, 0.1, SEED)
            _sync(dev)
            adam = state.opt_state[1][0]
            res[w] = {"seconds": time.perf_counter() - t0,
                      "parts": {k: float(v) for k, v in m.items()},
                      "params": {k: v.detach().double().cpu() for k, v in state.params.items()},
                      "adam": {f: {k: v.double().cpu() for k, v in adam[f].items()}
                               for f in ("mu", "nu")},
                      "collectives": dict(COLLECTIVES)}
    return out


def state_err(a: dict, b: dict) -> float:
    """max |a - b| over max(1, max |b|), the worst tensor of a state dict."""
    return max(float((a[k] - b[k]).abs().max()) / max(1.0, float(b[k].abs().max()))
               for k in b if b[k].is_floating_point())


def dual_pair_err(duals: list) -> tuple:
    """The dual pair's world 2 against world 1 in one dtype, over both
    ranks: each part over max(1, |world 1|), the parameters (``state_err``),
    Adam's ``mu`` and ``nu`` as their worst entry over their largest; →
    (errors, the ranks' parameters apart)."""
    err = {k: max(abs(d[2]["parts"][k] - v) / max(1.0, abs(v)) for d in duals)
           for k, v in duals[0][1]["parts"].items()}
    err["params"] = max(state_err(d[2]["params"], d[1]["params"]) for d in duals)
    for f in ("mu", "nu"):
        err[f] = max(max(float((d[2]["adam"][f][k] - v).abs().max())
                         for k, v in d[1]["adam"][f].items())
                     / max(float(v.abs().max()) for v in d[1]["adam"][f].values())
                     for d in duals)
    return err, state_err(duals[0][2]["params"], duals[1][2]["params"])


def phase_ddp(dev, smi: str, tmp_dir: str) -> dict:
    """``run_i3d --mesh`` on the one card (world 1 over NCCL) at full width
    beside the plain run, one epoch each of the train phase's tree; the
    mesh checkpoint resumed by the plain trainer; the step's device time
    plain and mesh, in turns; then two ranks on the card over gloo (the float32 step
    against world 1, the collectives carried) and ``dryrun_multichip``. → launches of
    K1 and K2 in this process over the mesh and plain runs."""
    from stdd_torch.data.dataset_i3d import I3DClipDataset
    from stdd_torch.models.i3d import I3D, IMAGENET_MEAN, IMAGENET_STD
    from stdd_torch.parallel import mesh
    from stdd_torch.parallel.dryrun import dryrun_multichip
    from stdd_torch.train import run_i3d
    from stdd_torch.train.engine_i3d import I3DTrainArgs, init_i3d_training

    tree = os.path.join(tmp_dir, "clips")
    n_clips = write_clip_tree(tree, np.random.RandomState(SEED + 7))       # set-up
    base = ["--data", tree, "--clip_size", str(TRAIN_T), "--crop_size", str(TRAIN_S),
            *TRAIN_ARGS, "--device", str(dev)]
    runs = {}
    warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0  # the paths start
    for name, extra in (("plain", []), ("mesh", ["--mesh"])):
        out = os.path.join(tmp_dir, f"ddp_{name}")
        t0 = time.perf_counter()
        state = run_i3d.main(base + ["--out", out, "--epochs", "1"] + extra)
        seconds = time.perf_counter() - t0
        stats, _ = read_train_log(os.path.join(out, "log.txt"))
        runs[name] = {"seconds": seconds, "steps": state.step,
                      "epoch_loss": [r["loss"] for r in stats if r["_type"] == "train_epoch"],
                      "val_auc": [r["value"] for r in stats if r["_type"] == "val_epoch"]}
    launches = {"warp_affine": warp_affine.launches, "fused_bottleneck": fused_bottleneck.launches}
    k3n = k3_read("ddp")                     # the trainer's validation scores in bf16 eval
    mesh_out = os.path.join(tmp_dir, "ddp_mesh")
    t0 = time.perf_counter()
    resumed = run_i3d.main(base + ["--out", mesh_out, "--epochs", "2", "--resume"])
    resume_s = time.perf_counter() - t0
    stats, _ = read_train_log(os.path.join(mesh_out, "log.txt"))
    resume_loss = [r["loss"] for r in stats if r["_type"] == "train_epoch"]

    # the step's device time on a fixed batch: plain, then world 1 over NCCL
    ds = I3DClipDataset(root_dir=tree, T=TRAIN_T, is_train=True, seed=SEED)
    clips, ys = next(ds.batches(8, seed=SEED))
    mean, std = (torch.as_tensor(a, device=dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
    x = (torch.from_numpy(clips).to(dev).float() - mean) / std
    y = torch.from_numpy(ys).to(dev)
    args = I3DTrainArgs(base_lr=0.01, max_epoch=1, warmup_epochs=0.5, warmup_start_lr=0.0025,
                        alter_freq=2, steps_per_epoch=8, grad_clip=1.0)
    mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0, dev.type)
    try:
        trainers = {}
        for name, dp in (("plain", None), ("mesh", mesh.DataParallel(0, 1))):
            model = I3D(I3DConfig(num_frames=TRAIN_T, crop_size=TRAIN_S),
                        dtype=torch.bfloat16).to(dev)
            st, step, _ = init_i3d_training(model, args, dp=dp)
            trainers[name] = [step, st]
        ms, peaks = {"plain": [], "mesh": []}, {}
        for name in ("plain", "mesh", "mesh", "plain"):                 # in turns
            step, st = trainers[name]
            t, peak, trainers[name][1] = timed_steps(step, st, x, y, DDP_TIMED_STEPS // 2)
            ms[name] += list(t)
            peaks[name] = max(peaks.get(name, 0), peak)
        step_ms = {k: {"median": float(np.median(v)), "p90": float(np.percentile(v, 90)),
                       "peak_gib_both_resident": peaks[k] / 2 ** 30} for k, v in ms.items()}
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    del x, trainers
    torch.cuda.empty_cache()

    # two ranks on the one card: NCCL refuses that, so the job picks gloo,
    # which carries CUDA tensors; then the dry run through its entry point
    t0 = time.perf_counter()
    pair = mesh.spawn(_ddp_pair, 2, (dev.type,), device=dev.type)
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, dev.type)
    dry_s = time.perf_counter() - t0

    world_err = max(max(abs(p[2]["loss"] - p[1]["loss"]) / max(1.0, abs(p[1]["loss"])),
                        state_err(p[2]["state"], p[1]["state"])) for p in pair)
    ranks_apart = state_err(pair[0][2]["state"], pair[1][2]["state"])
    dtypes = ("float32", "float64")
    duals = {dt: [p["dual"][dt] for p in pair] for dt in dtypes}
    dual_err, dual_apart = {}, {}
    for dt in dtypes:
        dual_err[dt], dual_apart[dt] = dual_pair_err(duals[dt])
    loss_rel = abs(runs["mesh"]["epoch_loss"][0] - runs["plain"]["epoch_loss"][0]) / max(
        1.0, abs(runs["plain"]["epoch_loss"][0]))
    r = {"phase": "ddp", "card": smi, "model": "I3D-R50", "clip": TRAIN_T, "crop": TRAIN_S,
         "batch": 8, "dtype": "bfloat16 compute, float32 weights", "clips": n_clips,
         "mesh_backend": backend, "mesh_world": 1, "runs": runs,
         "mesh_vs_plain_epoch_loss_rel": loss_rel,
         "resumed_by_plain": {"seconds": resume_s, "steps": resumed.step,
                              "epoch_loss": resume_loss},
         "step_ms": step_ms,
         "mesh_over_plain_step": step_ms["mesh"]["median"] / step_ms["plain"]["median"],
         "pair": {"backend": [p["backend"] for p in pair], "world": 2, "cfg": DDP_PAIR_CFG,
                  "global_batch": 4, "dtype": "float32, TF32 off",
                  "seconds_with_spawn": pair_s,
                  "world2_vs_world1": world_err, "ranks_apart": ranks_apart,
                  "step_s": {w: [p[w]["seconds"] for p in pair] for w in (1, 2)},
                  "collectives_step": pair[0]["collectives_step"]},
         "pair_dual": {"model": "DualEncoderAU_LMK, run_dual's defaults (d_model 256, 4 layers, "
                                "dropout 0.15), DAT over 5 domains",
                       "args": "DualTrainArgs() (slerp, dat), dat_lambda 0.1",
                       "global_batch": DDP_DUAL_BATCH, "T": DDP_DUAL_T,
                       "dtype": "float32, TF32 off", "world": 2,
                       "parts_world1": {dt: duals[dt][0][1]["parts"] for dt in dtypes},
                       "world2_vs_world1": dual_err, "ranks_apart": dual_apart,
                       "step_s_warm_float32": {w: [d[w]["seconds"] for d in duals["float32"]]
                                               for w in (1, 2)},
                       "collectives_step": duals["float32"][0][2]["collectives"]},
         "dryrun": {"ranks": 2, "seconds_with_spawn": dry_s,
                    "per_rank": [{"i3d_loss": d["i3d_loss"], "dual_loss": d["dual_loss"],
                                  "probs": d["probs"].tolist(), "launches": d["launches"]}
                                 for d in dry]},
         "tol": {"mesh_vs_plain_epoch_loss_rel": DDP_LOSS_TOL, "world2_vs_world1": DDP_WORLD_TOL,
                 "dual_world2_vs_world1": DDP_DUAL_TOLS},
         "k1_launches": launches["warp_affine"], "k2_launches": launches["fused_bottleneck"],
         "k3_launches": k3n}
    emit(r)
    if not (runs["mesh"]["steps"] == runs["plain"]["steps"] > 0
            and np.isfinite(runs["mesh"]["epoch_loss"]).all()):
        raise AssertionError(f"ddp: runs {runs}")
    if not loss_rel <= DDP_LOSS_TOL:
        raise AssertionError(f"ddp: mesh epoch loss {loss_rel} from the plain run's")
    if not (resumed.step == 2 * runs["mesh"]["steps"] and len(resume_loss) == 2
            and np.isfinite(resume_loss).all()):
        raise AssertionError(f"ddp: the plain trainer did not resume the mesh checkpoint "
                             f"(steps {resumed.step}, losses {resume_loss})")
    if backend != "nccl":
        raise AssertionError(f"ddp: the mesh ran over {backend}, not NCCL")
    if not (world_err <= DDP_WORLD_TOL and ranks_apart == 0.0
            and [p["backend"] for p in pair] == ["gloo", "gloo"]):
        raise AssertionError(f"ddp: world 2 vs 1 {world_err}, ranks apart {ranks_apart}")
    after_step = ("params", "mu", "nu")
    for dt in dtypes:
        parts, err, tol = duals[dt][0][2]["parts"], dual_err[dt], DDP_DUAL_TOLS[dt]
        if "dat" not in parts:
            raise AssertionError(f"ddp: the {dt} dual step ran without DAT: {parts}")
        if not (max(v for k, v in err.items() if k not in after_step) <= tol["parts"]
                and all(err[k] <= tol[k] for k in after_step) and dual_apart[dt] == 0.0
                and np.isfinite(list(parts.values())).all()):
            raise AssertionError(f"ddp: {dt} dual world 2 vs 1 {err}, "
                                 f"ranks apart {dual_apart[dt]}")
    for d in dry:
        if not (np.isfinite([d["i3d_loss"], d["dual_loss"]]).all()
                and np.isfinite(d["probs"]).all()
                and d["launches"] == {"warp_affine": 1, "fused_bottleneck": 0}):
            raise AssertionError(f"ddp: dry run {d}")
    if not np.array_equal(dry[0]["probs"], dry[1]["probs"]):
        raise AssertionError("ddp: the dry run's ranks gathered different probs")
    if launches["warp_affine"] or launches["fused_bottleneck"]:
        raise AssertionError("ddp: K1/K2 launched in training")
    return launches


def int8_scorers(dev, cfg, int8: bool, seed: int = SEED):
    """The full-width I420 scorer over seeded random weights (BN randomized),
    bf16, with or without the int8 knob."""
    base = ClipScorer.random_init(cfg, seed=seed, device="cpu", dtype=torch.float32)
    randomize_bn(base.model, seed)
    return ClipScorer(base.model.state_dict(), cfg=cfg, upload_format="yuv420", device=dev,
                      int8=int8)


def phase_int8(dev, smi: str) -> dict:
    """The int8 serving knob at full width (I3D-R50, 32×224², bf16, I420):
    ms a batch with and without it at B = 2 and 8 (in turns), |Δp|, K1 once
    a batch and the integer GEMMs of s3-s5 (42 a forward); with ``fused_s2``
    K2's 3 launches a forward; float32 int8 card vs CPU (8×64²); one s4
    convolution's int32 accumulators bit-equal to the plain version, its
    int8 product beside the bf16 cuDNN convolution; the app over a 720p
    scene with the int8 scorer. → {kernel: {path: launches}}."""
    from stdd_torch.eval.bench_scene import BenchScene
    from stdd_torch.models import i3d

    cfg = I3DConfig()
    T, S = cfg.num_frames, 256
    fl, q8 = int8_scorers(dev, cfg, False), int8_scorers(dev, cfg, True)
    if q8.cfg.int8_stages != ("s3", "s4", "s5"):
        raise AssertionError(f"int8: stages {q8.cfg.int8_stages}")
    rng = np.random.RandomState(SEED + 80)
    launches = {"warp_affine": {}, "fused_bottleneck": {}}
    per_b = {}
    for B in INT8_BATCHES:
        ws = [torch.from_numpy(w).to(dev) for w in clip_windows(rng, B, T, S)]
        geo = [clip_geometry(rng, T) for _ in range(B)]
        boxes, lm5, scale = (np.stack([g[i] for g in geo]) for i in range(3))
        valid = np.ones((B,), bool)

        def run(s):
            return np.asarray(s.score_windows(ws, boxes, lm5, scale, valid))

        probs = {k: run(s) for k, s in (("float", fl), ("int8", q8))}      # warm-up
        ms = {"float": [], "int8": []}
        counts = {"float": np.zeros(4, int), "int8": np.zeros(4, int)}   # K1, K2, GEMMs, K3
        for order in (("float", "int8"), ("int8", "float")):
            for k in order:
                s = fl if k == "float" else q8
                torch.cuda.synchronize()
                warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0
                n8 = i3d.int8_conv_acc.launches
                for _ in range(INT8_TIMED):
                    t0 = time.perf_counter()
                    run(s)
                    ms[k].append((time.perf_counter() - t0) * 1000)
                counts[k] += (warp_affine.launches, fused_bottleneck.launches,
                              i3d.int8_conv_acc.launches - n8, k3.bias_act.launches)
        counts = {k: [int(n) for n in v] for k, v in counts.items()}
        launches["warp_affine"][f"int8_b{B}"] = counts["int8"][0]
        launches["fused_bottleneck"][f"int8_b{B}"] = counts["int8"][1]
        k3_read(f"int8_b{B}", counts["int8"][3])
        per_b[B] = {"ms_per_batch_median": {k: float(np.median(v)) for k, v in ms.items()},
                    "ms_per_batch_p90": {k: float(np.percentile(v, 90)) for k, v in ms.items()},
                    "int8_over_float": float(np.median(ms["int8"]) / np.median(ms["float"])),
                    "dp_int8_vs_float": float(np.abs(probs["int8"] - probs["float"]).max()),
                    "probs_int8": probs["int8"].tolist(),
                    "k1_launches_int8": counts["int8"][0],
                    "int8_gemms_per_batch": counts["int8"][2] / (2 * INT8_TIMED),
                    "k3_per_batch": {k: v[3] / (2 * INT8_TIMED) for k, v in counts.items()},
                    "batches_int8": 2 * INT8_TIMED}
        del ws

    # fused_s2 + int8: K2 on s2, int8 on s3-s5
    fz = int8_scorers(dev, dataclasses.replace(cfg, fused_s2=True), True)
    B = 8
    ws = [torch.from_numpy(w).to(dev) for w in clip_windows(rng, B, T, S)]
    geo = [clip_geometry(rng, T) for _ in range(B)]
    boxes, lm5, scale = (np.stack([g[i] for g in geo]) for i in range(3))
    valid = np.ones((B,), bool)
    pu = np.asarray(q8.score_windows(ws, boxes, lm5, scale, valid))
    np.asarray(fz.score_windows(ws, boxes, lm5, scale, valid))              # warm-up
    torch.cuda.synchronize()
    warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0
    t0 = time.perf_counter()
    pf = np.asarray(fz.score_windows(ws, boxes, lm5, scale, valid))
    fused_ms = (time.perf_counter() - t0) * 1000
    launches["warp_affine"]["int8_fused"] = warp_affine.launches
    launches["fused_bottleneck"]["int8_fused"] = fused_bottleneck.launches
    k3_read("int8_fused")
    del fz, ws

    # float32 int8 probs, card vs CPU, at 8×64²
    small = I3DConfig(num_frames=8, crop_size=64)
    sd = ClipScorer.random_init(small, seed=SEED, device="cpu").model.state_dict()
    c = np.random.RandomState(SEED + 81)
    crops = c.randint(0, 255, (2, 8, 96, 96, 3)).astype(np.uint8)
    sboxes = np.tile(np.array([5, 5, 90, 90], np.float32), (2, 8, 1))
    slm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (2, 8, 1, 1))
    p32 = {str(w): ClipScorer(sd, cfg=small, dtype=torch.float32, device=w, int8=True).score(
        crops, sboxes, slm5, np.ones(2, bool)) for w in ("cpu", dev)}
    f32_dp = float(np.abs(p32[str(dev)] - p32["cpu"]).max())

    # one s4 convolution (1×3×3, 256 → 256, B = 8, T = 8, 14²): the integers
    # on the card against the plain version, and the int8 product's time
    # beside the bf16 cuDNN convolution of the same shapes
    g = torch.Generator(device=dev).manual_seed(SEED)
    xq = torch.randint(-127, 128, (8, 256, 8, 14, 14), generator=g, device=dev,
                       dtype=torch.int8).contiguous(memory_format=torch.channels_last_3d)
    wq = torch.randint(-127, 128, (256, 256, 1, 3, 3), generator=g, device=dev, dtype=torch.int8)
    acc = i3d.int8_conv_acc(xq, wq, (1, 1, 1), (0, 1, 1))
    ref = i3d.int8_conv_acc_reference(xq, wq, (1, 1, 1), (0, 1, 1))
    acc_equal = bool(torch.equal(acc, ref))
    xf = torch.randn((8, 256, 8, 14, 14), generator=g, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    wf = torch.randn((256, 256, 1, 3, 3), generator=g, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    conv_ms = {"int8_acc": event_ms(lambda: i3d.int8_conv_acc(xq, wq, (1, 1, 1), (0, 1, 1)), 20),
               "int8_conv_with_quantize": event_ms(
                   lambda: i3d.int8_conv(xf, wf, (1, 1, 1), (0, 1, 1)), 20),
               "bf16_cudnn": event_ms(lambda: F.conv3d(xf, wf, None, 1, (0, 1, 1)), 20)}
    del xq, wq, acc, ref, xf, wf

    # the app with the int8 scorer over a 720p scene of one face
    scene = BenchScene(APP_FILE_HW, n_faces=1, seed=SEED + 61, device=str(dev))
    frames = [scene.frame(i) for i in range(INT8_APP_FRAMES)]                 # set-up
    app_res = run_app_over(q8, frames, oracle_rows(scene, INT8_APP_FRAMES))
    launches["warp_affine"]["int8_app"] = app_res["k1_launches"]
    launches["fused_bottleneck"]["int8_app"] = app_res["k2_launches"]
    k3_read("int8_app", app_res["k3_launches"])
    del frames

    r = {"phase": "int8", "card": smi, "model": "I3D-R50", "clip": T, "crop": cfg.crop_size,
         "dtype": "bfloat16 compute; int8 s3-s5", "upload": "yuv420",
         "by_batch": {str(b): v for b, v in per_b.items()},
         "fused_s2_int8": {"B": 8, "ms_one_batch": fused_ms, "k1_launches":
                           launches["warp_affine"]["int8_fused"],
                           "k2_launches": launches["fused_bottleneck"]["int8_fused"],
                           "k3_launches": k3_by_path["int8_fused"],
                           "dp_vs_unfused_int8": float(np.abs(pf - pu).max())},
         "f32_card_vs_cpu_dp": f32_dp, "f32_small": "8×64², B = 2",
         "s4_conv_acc_bit_equal": acc_equal, "s4_conv_ms": conv_ms,
         "app": {k: v for k, v in app_res.items() if k != "scores"},
         "tol": {"f32_card_vs_cpu_dp": INT8_F32_TOL, "dp_int8_vs_float": INT8_DP_TOL}}
    emit(r)
    for B, v in per_b.items():
        if not (v["k1_launches_int8"] == v["batches_int8"] and v["int8_gemms_per_batch"] == 42):
            raise AssertionError(f"int8 B={B}: K1 {v['k1_launches_int8']} for "
                                 f"{v['batches_int8']} batches, {v['int8_gemms_per_batch']} "
                                 "integer GEMMs a batch")
        want3 = {"float": K3_PER_FORWARD["i3d"], "int8": K3_PER_FORWARD["int8"]}
        if v["k3_per_batch"] != want3:
            raise AssertionError(f"int8 B={B}: K3 {v['k3_per_batch']} a batch (want {want3})")
        p = np.array(v["probs_int8"])
        if not (np.isfinite(p).all() and v["dp_int8_vs_float"] <= INT8_DP_TOL):
            raise AssertionError(f"int8 B={B}: probs {p}, |Δp| {v['dp_int8_vs_float']}")
    if not (launches["fused_bottleneck"]["int8_fused"] == 3
            and launches["warp_affine"]["int8_fused"] == 1
            and k3_by_path["int8_fused"] == K3_PER_FORWARD["fused_s2_int8"]):
        raise AssertionError(f"int8: fused_s2 launches {launches}")
    if not f32_dp <= INT8_F32_TOL:
        raise AssertionError(f"int8: float32 card vs CPU |Δp| {f32_dp}")
    if not acc_equal:
        raise AssertionError("int8: the s4 accumulators differ from the plain version")
    if not (app_res["frames_seen"] == INT8_APP_FRAMES and app_res["k1_launches"] > 0
            and app_res["k1_launches"] == app_res["batches_dispatched"]
            and app_res["k3_launches"] == K3_PER_FORWARD["int8"] * app_res["batches_dispatched"]):
        raise AssertionError(f"int8: app {app_res}")
    return launches


def phase_slice15(dev, smi: str) -> dict:
    """Phases 38-39 (ddp, int8); → {kernel: {phase: launches}} (counted from zero just
    before each path and read just after)."""
    launches = {"warp_affine": {}, "fused_bottleneck": {}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_dir:
        ddp = phase_ddp(dev, smi, tmp_dir)
    emit({"phase": "ddp_wall", "seconds": time.perf_counter() - t0})
    for k in launches:
        launches[k]["ddp"] = ddp[k]
    q8 = phase_int8(dev, smi)
    for k in launches:
        launches[k].update(q8[k])
    return launches


# -- phase 40: the scorer's reference-quantization mode --------------------------
SLICE16_BATCHES = (2, 8)
SLICE16_TIMED = 5            # scored batches timed a configuration and round (two rounds)
# float32 probs of a two-class head scored on its second logit, card vs CPU
# (8×64²): float32 sums in another order (FTCN_SERVE_TOL's bound)
SLICE16_F32_TOL = 1e-4
# the I3D's input de-normalized: K1's aligned clip, clamped to [0, 255] and
# rounded half to even (torch.round, as jnp.round), element by element, to
# within float32 rounding of (p - mean) / std · std + mean (255 · 2⁻²³ ≈
# 3e-5); the check sees a wrong rounding only where K1's values lie away from
# an integer, so some must lie more than 0.25 from one
SLICE16_PIXEL_TOL = 1e-3


def model_inputs(scorer, fn):
    """``fn()``'s result, the pixel values each of the scorer's I3D forwards
    received (its input de-normalized) and K1's aligned clip each forward
    came from, on the scorer's device."""
    seen, aligned = [], []
    align = scorer._align_batch

    def kept(*a, **kw):
        out = align(*a, **kw)
        aligned.append(out.detach())
        return out

    hook = scorer.model.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach()))
    scorer._align_batch = kept
    try:
        out = fn()
    finally:
        hook.remove()
        del scorer._align_batch
    return out, [x * scorer._std + scorer._mean for x in seen], aligned


def phase_slice16(dev, smi: str) -> dict:
    """Phase 40: ``round_aligned_u8`` at full width (I3D-R50, 32×224², I420
    ring windows, bf16 and float32) at B = 2 and 8, through K1 and through
    its plain version; ms a batch with and without the rounding (bf16, in
    turns); one ``fused_s2`` batch with it; a two-class head on
    ``score_index=1`` card vs CPU. → {kernel: {path: launches}}."""
    cfg = I3DConfig()
    T, S = cfg.num_frames, 256
    base = ClipScorer.random_init(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    randomize_bn(base.model, SEED)
    sd = base.model.state_dict()
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def scorer(dt, rounded, c=cfg):
        return ClipScorer(sd, cfg=c, dtype=dtypes[dt], score_index=0, round_aligned_u8=rounded,
                          upload_format="yuv420", device=dev)

    sc = {(dt, r): scorer(dt, r) for dt in dtypes for r in (True, False)}
    rng = np.random.RandomState(SEED + 90)
    launches = {"warp_affine": {}, "fused_bottleneck": {}}
    per_b = {}
    for B in SLICE16_BATCHES:
        ws = [torch.from_numpy(w).to(dev) for w in clip_windows(rng, B, T, S)]
        geo = [clip_geometry(rng, T) for _ in range(B)]
        boxes, lm5, scale = (np.stack([g[i] for g in geo]) for i in range(3))
        valid = np.ones((B,), bool)

        def run(s):
            return np.asarray(s.score_windows(ws, boxes, lm5, scale, valid))

        probs, pixels = {}, {}
        for (dt, r), s in sc.items():                       # also the warm-up
            probs[(dt, r)], px, al = model_inputs(s, lambda: run(s))
            x, a = px[0], al[0]
            if r:
                pixels[dt] = {"max_from_integer": float((x - x.round()).abs().max()),
                              "min": float(x.min()), "max": float(x.max()),
                              "vs_k1_rounded": float((x - torch.round(torch.clamp(a, 0, 255)))
                                                     .abs().max()),
                              "k1_max_from_integer": float((a - a.round()).abs().max()),
                              "k1_share_over_quarter_from_integer": float(
                                  ((a - a.round()).abs() > 0.25).float().mean())}
            else:
                pixels[f"{dt}_unrounded_vs_k1"] = float((x - a).abs().max())
        plain = {}
        for dt in dtypes:                                   # the plain warp in K1's place
            s = sc[(dt, True)]
            plain[dt] = s._score_impl(
                torch.stack(ws), s._to_device(boxes, torch.float32),
                s._to_device(lm5, torch.float32), s._to_device(valid, torch.bool),
                scale=s._to_device(scale, torch.float32),
                warp=warp_affine_reference).cpu().numpy()
        ms = {"rounded": [], "unrounded": []}
        k1 = k2 = k3n = 0
        for order in (("rounded", "unrounded"), ("unrounded", "rounded")):
            for k in order:
                s = sc[("bf16", k == "rounded")]
                torch.cuda.synchronize()
                warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0
                for _ in range(SLICE16_TIMED):
                    t0 = time.perf_counter()
                    run(s)
                    ms[k].append((time.perf_counter() - t0) * 1000)
                if k == "rounded":
                    k1 += warp_affine.launches
                    k2 += fused_bottleneck.launches
                    k3n += k3.bias_act.launches
        launches["warp_affine"][f"slice16_b{B}"] = k1
        launches["fused_bottleneck"][f"slice16_b{B}"] = k2
        k3_read(f"slice16_b{B}", k3n)
        med = {k: float(np.median(v)) for k, v in ms.items()}
        per_b[B] = {
            "ms_per_batch_median": med,
            "ms_per_batch_p90": {k: float(np.percentile(v, 90)) for k, v in ms.items()},
            "rounding_ms_per_batch": med["rounded"] - med["unrounded"],
            "pixels_rounded": pixels,
            "probs_rounded": {dt: probs[(dt, True)].tolist() for dt in dtypes},
            "dp_rounded_vs_unrounded": {dt: float(np.abs(probs[(dt, True)]
                                                         - probs[(dt, False)]).max())
                                        for dt in dtypes},
            "dp_k1_vs_plain_warp": {dt: float(np.abs(probs[(dt, True)] - plain[dt]).max())
                                    for dt in dtypes},
            "f32_k1_equals_plain_warp": bool(np.array_equal(probs[("f32", True)],
                                                            plain["f32"])),
            "dp_bf16_vs_f32_rounded": float(np.abs(probs[("bf16", True)]
                                                   - probs[("f32", True)]).max()),
            "k1_launches": k1, "k2_launches": k2, "batches": 2 * SLICE16_TIMED}
        del ws

    # fused_s2 with the rounding: K2 on s2's three blocks, K1 once
    fz = scorer("bf16", True, dataclasses.replace(cfg, fused_s2=True))
    B = 8
    ws = [torch.from_numpy(w).to(dev) for w in clip_windows(rng, B, T, S)]
    geo = [clip_geometry(rng, T) for _ in range(B)]
    boxes, lm5, scale = (np.stack([g[i] for g in geo]) for i in range(3))
    valid = np.ones((B,), bool)
    p32 = np.asarray(sc[("f32", True)].score_windows(ws, boxes, lm5, scale, valid))
    np.asarray(fz.score_windows(ws, boxes, lm5, scale, valid))              # warm-up
    torch.cuda.synchronize()
    warp_affine.launches = fused_bottleneck.launches = k3.bias_act.launches = 0
    t0 = time.perf_counter()
    pf = np.asarray(fz.score_windows(ws, boxes, lm5, scale, valid))
    fused_ms = (time.perf_counter() - t0) * 1000
    launches["warp_affine"]["slice16_fused"] = warp_affine.launches
    launches["fused_bottleneck"]["slice16_fused"] = fused_bottleneck.launches
    k3_read("slice16_fused")
    del fz, ws, sc

    # a two-class head scored on its second logit, float32, card vs CPU
    small = I3DConfig(num_frames=8, crop_size=64, num_classes=2)
    sd2 = ClipScorer.random_init(small, seed=SEED, device="cpu").model.state_dict()
    c = np.random.RandomState(SEED + 91)
    crops = c.randint(0, 255, (2, 8, 96, 96, 3)).astype(np.uint8)
    sboxes = np.tile(np.array([5, 5, 90, 90], np.float32), (2, 8, 1))
    slm5 = np.tile((STD_POINTS_256 * 0.3 + 10).astype(np.float32), (2, 8, 1, 1))
    two = {str(w): ClipScorer(sd2, cfg=small, dtype=torch.float32, device=w,
                              score_index=1).score_with_features(crops, sboxes, slm5,
                                                                 np.ones(2, bool))
           for w in ("cpu", dev)}
    p_card, logits_card, _ = two[str(dev)]
    two_dp = float(np.abs(p_card - two["cpu"][0]).max())
    second = float(np.abs(p_card - 1 / (1 + np.exp(-logits_card[:, 1]))).max())

    r = {"phase": "slice16", "card": smi, "model": "I3D-R50", "clip": T, "crop": cfg.crop_size,
         "upload": "yuv420", "round_aligned_u8": True, "score_index": 0,
         "by_batch": {str(b): v for b, v in per_b.items()},
         "fused_s2_rounded": {"B": 8, "ms_one_batch": fused_ms,
                              "k1_launches": launches["warp_affine"]["slice16_fused"],
                              "k2_launches": launches["fused_bottleneck"]["slice16_fused"],
                              "dp_vs_f32_unfused": float(np.abs(pf - p32).max())},
         "two_class": {"cfg": "I3D-R50, 8×64², 2 classes", "score_index": 1,
                       "f32_card_vs_cpu_dp": two_dp, "probs_card": p_card.tolist(),
                       "logits_card": logits_card.tolist(), "probs_vs_sigmoid_logit1": second},
         "tol": {"bf16_vs_f32_dp": TOLS["bf16_vs_f32_dp"], "pixel": SLICE16_PIXEL_TOL,
                 "two_class_f32_card_vs_cpu_dp": SLICE16_F32_TOL}}
    emit(r)
    for B, v in per_b.items():
        for dt in dtypes:
            px = v["pixels_rounded"][dt]
            if not (px["max_from_integer"] <= SLICE16_PIXEL_TOL
                    and px["min"] >= -SLICE16_PIXEL_TOL and px["max"] <= 255 + SLICE16_PIXEL_TOL
                    and px["vs_k1_rounded"] <= SLICE16_PIXEL_TOL
                    and px["k1_max_from_integer"] > 0.25
                    and v["pixels_rounded"][f"{dt}_unrounded_vs_k1"] <= SLICE16_PIXEL_TOL):
                raise AssertionError(f"slice16 B={B} {dt}: the I3D's input is not K1's clip "
                                     f"rounded half to even: {v['pixels_rounded']}")
        p = np.array(v["probs_rounded"]["bf16"])
        if not (np.isfinite(p).all() and v["f32_k1_equals_plain_warp"]
                and v["dp_k1_vs_plain_warp"]["bf16"] <= TOLS["bf16_vs_f32_dp"]
                and v["dp_bf16_vs_f32_rounded"] <= TOLS["bf16_vs_f32_dp"]):
            raise AssertionError(f"slice16 B={B}: probs {v}")
        if not (v["k1_launches"] == v["batches"] and v["k2_launches"] == 0):
            raise AssertionError(f"slice16 B={B}: K1 {v['k1_launches']}, K2 {v['k2_launches']} "
                                 f"for {v['batches']} batches")
    if not (launches["fused_bottleneck"]["slice16_fused"] == 3
            and launches["warp_affine"]["slice16_fused"] == 1
            and float(np.abs(pf - p32).max()) <= FUSED_TOLS["bf16_vs_f32_dp"]):
        raise AssertionError(f"slice16: fused_s2 {launches}, |Δp| {np.abs(pf - p32).max()}")
    if not (two_dp <= SLICE16_F32_TOL and second <= 1e-6):
        raise AssertionError(f"slice16: two-class |Δp| {two_dp}, vs sigmoid(logit 1) {second}")
    return launches


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
    with ThreadPoolExecutor(3) as pool:
        futs = {"warp_affine": pool.submit(timed, build_kernel),
                "fused_bottleneck": pool.submit(timed, k2.build_kernel),
                "bias_act": pool.submit(timed, k3.build_kernel)}
        build_s = {k: f.result() for k, f in futs.items()}
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = native_available()
    rec = {"phase": "build", "kernels_wall_s": t_kernels, "native_s": time.perf_counter() - t0,
           "native": native}
    for k in ("warp_affine", "fused_bottleneck", "bias_act"):
        info = build_info[k]
        rec.update({f"{k}_s": build_s[k], f"{k}_library": info["library"],
                    f"{k}_reused": info["reused"],
                    f"{k}_ptxas": info["ptxas"].strip().splitlines()})
    emit(rec)

    k1_err, k1_timings = phase_k1(dev)
    k2_err = phase_k2_check(dev)
    k2_timings = phase_k2_time(dev)
    k3_err, k3_timings = phase_k3(dev)
    scorer = phase_scorer(dev)
    scene = Scene((1080, 1920), n_faces=1, seed=SEED)
    # rendered before any clock starts: making data is set-up
    frames = [scene.frame(i) for i in range(ENGINE_WARM + ENGINE_FRAMES)]
    engine_res, n_main = phase_engine(scorer, smi, scene, frames)
    k1_launches = engine_res["k1_launches"]
    with tempfile.TemporaryDirectory() as tmp_dir:
        det = phase_detector(dev, tmp_dir, smi)
        det_res = phase_engine_detector(scorer, det, smi, scene, frames, engine_res)
        server_res = phase_server(scorer, smi)
        app_res = phase_app(scorer, det, smi, scene, frames)
        del frames, det
        fused16 = phase_fused_scorer(dev, scorer, tmp_dir)
    k2_launches, dense_k1 = phase_dense(fused16, scorer, smi)
    del fused16
    with tempfile.TemporaryDirectory() as tmp_dir:
        eval_launches = phase_eval(dev, smi, scorer, tmp_dir)
    t0 = time.perf_counter()
    capstone_launches = phase_capstone_fusion(dev, smi)
    emit({"phase": "capstone_fusion_wall", "seconds": time.perf_counter() - t0})
    # each kernel's launches on every path that counted them
    by_phase = {
        "warp_affine": {"engine": k1_launches, "engine_detector": det_res["k1_launches"],
                        **{f"server_{n}calls_{wait}": r["k1_launches"]
                           for (n, wait), r in server_res.items()},
                        "app": app_res["k1_launches"], "dense": dense_k1,
                        **eval_launches["warp_affine"], **capstone_launches["warp_affine"]},
        "fused_bottleneck": {"dense": k2_launches, **eval_launches["fused_bottleneck"],
                             **capstone_launches["fused_bottleneck"]}}
    with tempfile.TemporaryDirectory() as tmp_dir:
        ckpt = phase_train(dev, smi, tmp_dir)
        trained16 = ClipScorer.from_jax_checkpoint(ckpt, upload_format="yuv420", device=dev)
        serve_fused(dev, ckpt, trained16.model, "train_served", TRAINED_TOLS, 0.0)
        del trained16
    with tempfile.TemporaryDirectory() as tmp_dir:
        phase_dual(dev, smi, tmp_dir)
    phase_landmarker(dev, smi)
    au = phase_au(dev, smi)
    with tempfile.TemporaryDirectory() as tmp_dir:
        phase_preprocess(dev, smi, tmp_dir, au)
    del au
    phase_landmarker_train(dev, smi)
    t0 = time.perf_counter()
    file_launches = phase_data_file(dev, smi, scorer)
    emit({"phase": "data_file_wall", "seconds": time.perf_counter() - t0})
    for k in by_phase:
        by_phase[k].update(file_launches[k])
    t0 = time.perf_counter()
    slice_launches = phase_slice13(dev, smi, scorer)
    emit({"phase": "slice13_wall", "seconds": time.perf_counter() - t0})
    for k in by_phase:
        by_phase[k].update(slice_launches[k])
    t0 = time.perf_counter()
    slice_launches = phase_slice14(dev, smi)
    emit({"phase": "slice14_wall", "seconds": time.perf_counter() - t0})
    for k in by_phase:
        by_phase[k].update(slice_launches[k])
    t0 = time.perf_counter()
    slice_launches = phase_slice15(dev, smi)
    emit({"phase": "slice15_wall", "seconds": time.perf_counter() - t0})
    for k in by_phase:
        by_phase[k].update(slice_launches[k])
    t0 = time.perf_counter()
    slice_launches = phase_slice16(dev, smi)
    emit({"phase": "slice16_wall", "seconds": time.perf_counter() - t0})
    for k in by_phase:
        by_phase[k].update(slice_launches[k])

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
         "launches_by_phase": by_phase["warp_affine"],
         "max_abs_err": k1_err, "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"], "library_ms": t1["library_ms"]},
        {"name": "fused_bottleneck", "route": "cuda",
         "source": "stdd_torch/csrc/fused_bottleneck.cu",
         "replaces": "stdd_tpu/ops/bottleneck_pallas.py:148", "launches": k2_launches,
         "launches_by_phase": by_phase["fused_bottleneck"],
         "max_abs_err": k2_err, "ms": per_launch["ms"], "plain_ms": per_launch["plain_ms"],
         "bound_ms": max(per_launch["bytes_ms"], per_launch["ops_ms"]), "bound_by": k2_bound_by,
         "library_ms": None},
        k3_entry(k3_err, k3_timings)]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
