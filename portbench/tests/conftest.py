"""Shared fixtures of the benchmark's own tests: a copy of the benchmark's
files with tiny cells beside the real ones, for runs on the CPU.

Run them from the repository's root:

    python -m pytest portbench/tests -q

The tests marked ``cuda`` run only where a card is visible; elsewhere they
skip with the reason "no CUDA device".
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a configuration of the real one's kind at a width the CPU runs in seconds
TINY_MODEL = dict(width_per_group=4, num_frames=8, crop_size=32)
# the tiny cells serve in float32, so a sound dense run reads gaps of
# rounding alone (under 2e-5) and the limits can be tight: a tiny network's
# windows score alike, so a fault moves its gaps by hundredths, not tenths
# as at full width. The live reference packs its crops with its own area
# resize and I420 encoder, a grey level off the ring's on ~2% of pixels,
# which a tiny crop feels (gaps to about 0.003); the tiny faces (50 px)
# move a larger share of their size between detections (landmark_err up
# to about 0.35)
TINY_LIMITS = {"logit_gap": 1e-3, "step_gap": 1e-3}
TINY_LIVE_LIMITS = {"logit_gap": 0.01, "step_gap": 0.01, "landmark_err": 0.5}


def write_tiny_cells(bench: Path) -> None:
    """Add tiny cells to a benchmark directory: ``tiny.dense`` and
    ``tiny.live`` over the configuration ``tiny``."""
    cfg = json.loads((bench / "configs" / "i3d_r50.json").read_text())
    cfg["name"] = "tiny"
    cfg["model"].update(TINY_MODEL)
    cfg["serving"].update(crop_buffer=40, dtype="float32")
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    dense = json.loads((bench / "traffic" / "dense_ffpp.json").read_text())
    dense.update(track_frames=[11, 15, 19], batch=4, face_px=[14, 18], check_pairs=8)
    (bench / "traffic" / "dense_tiny.json").write_text(json.dumps(dense))
    live = json.loads((bench / "traffic" / "grid_calls.json").read_text())
    live["motion"]["tile_margin_px"] = 4
    live.update(calls=2, frame_hw=[180, 320], render_frames=40, preroll_frames=40,
                check_pairs=4,
                pipeline={"clip_size": 8, "stride": 6, "detect_every": 4, "batch_clips": 8})
    (bench / "traffic" / "grid_tiny.json").write_text(json.dumps(live))
    (bench / "workloads" / "tiny.dense.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "dense_tiny", "chips": 1, "limits": TINY_LIMITS}))
    (bench / "workloads" / "tiny.live.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "grid_tiny", "chips": 1,
         "limits": TINY_LIVE_LIMITS}))


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    """A copy of ``portbench/`` with the tiny cells added."""
    bench = tmp_path_factory.mktemp("bench") / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    write_tiny_cells(bench)
    return bench


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
