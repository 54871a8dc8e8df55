"""The output check's control on the card: the program's own int8 path
(``ClipScorer(int8=True)``, s3-s5 in int8), one precision below the bf16
the configurations state, must come out not correct, at each dense cell's
own size, on three seeds; the sound program on the same seeds is correct.
Windows are short (the check compares as many windows as a run does).

    python -m pytest portbench/tests/test_portbench_control.py -q
"""

from __future__ import annotations

import time

import pytest

from portbench.lib.harness import run_cell
from portbench.lib.registry import Cell

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["i3d_r50.dense"])
def test_the_int8_control_is_not_correct(cuda_device, workload):
    cell = Cell(workload)
    for seed in SEEDS:
        out, checks = run_cell(cell, seed, 3.0, False, cuda_device, time.perf_counter(),
                               variant="int8")
        assert not out["correct"], (seed, checks)
    out, checks = run_cell(cell, SEEDS[0], 3.0, False, cuda_device, time.perf_counter())
    assert out["correct"], checks
