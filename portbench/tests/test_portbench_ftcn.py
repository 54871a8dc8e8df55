"""The FTCN-TT cell: a tiny copy on the CPU, sound and with each fault
planted under the timed path, and the int8 control at the cell's own size
on the card.

    python -m pytest portbench/tests/test_portbench_ftcn.py -q
"""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from conftest import BENCH, TINY_LIMITS

from portbench.lib.check import FAULTS
from portbench.lib.harness import run_cell
from portbench.lib.registry import Cell

SEEDS = (2**31 + 201, 2**31 + 202, 2**31 + 203)


@pytest.fixture(scope="module")
def tiny_ftcn(tmp_path_factory):
    """A copy of ``portbench/`` with ``tiny_ftcn.dense``: the FTCN-TT
    configuration at ResNet-18 depths, 8 channels a group, 8x32x32, float32,
    over three short tracks."""
    bench = tmp_path_factory.mktemp("bench_ftcn") / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs" / "ftcn_r50.json").read_text())
    cfg["name"] = "tiny_ftcn"
    cfg["model"].update(depth=18, width_per_group=8, num_frames=8, crop_size=32)
    for key in ("dim", "time_tokens"):             # the trunk's, at the tiny width
        cfg["head"].pop(key)
    cfg["serving"].update(crop_buffer=40, dtype="float32")
    (bench / "configs" / "tiny_ftcn.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "dense_ffpp_ftcn.json").read_text())
    mix.update(track_frames=[11, 15, 19], batch=4, face_px=[14, 18], check_pairs=8)
    (bench / "traffic" / "dense_tiny_ftcn.json").write_text(json.dumps(mix))
    (bench / "workloads" / "tiny_ftcn.dense.json").write_text(json.dumps(
        {"config": "tiny_ftcn", "traffic": "dense_tiny_ftcn", "chips": 1,
         "limits": TINY_LIMITS}))
    return bench


def test_the_check_passes_a_sound_run_and_fails_every_fault(tiny_ftcn):
    torch.set_num_threads(2)
    c = Cell("tiny_ftcn.dense", tiny_ftcn)
    out, checks = run_cell(c, 2**33 + 17, 0.6, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0, checks
    for fault in FAULTS:
        out, checks = run_cell(c, 2**33 + 17, 0.6, False, torch.device("cpu"),
                               time.perf_counter(), fault=fault)
        assert not out["correct"], (fault, checks)


def test_the_traced_record_is_dense_and_reads_the_head(tiny_ftcn):
    """The record keeps ``kind: dense`` with FTCN-TT's FLOPs, so the dense
    readers read it, and the head's span reads."""
    torch.set_num_threads(2)
    c = Cell("tiny_ftcn.dense", tiny_ftcn)
    out, _ = run_cell(c, 2**33 + 18, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert out["metrics"]["scorer.head_ms.ftcn"]["value"] > 0
    assert "scorer.track_upload_ms.dense" in out["metrics"]


@pytest.mark.cuda
def test_the_int8_control_is_not_correct(cuda_device):
    """s3-s4 in int8, one precision below the stated bf16, is not correct
    on three seeds; the sound program on the same seed is."""
    cell = Cell("ftcn_r50.dense")
    for seed in SEEDS:
        out, checks = run_cell(cell, seed, 3.0, False, cuda_device, time.perf_counter(),
                               variant="int8")
        assert not out["correct"], (seed, checks)
    out, checks = run_cell(cell, SEEDS[0], 3.0, False, cuda_device, time.perf_counter())
    assert out["correct"], checks
