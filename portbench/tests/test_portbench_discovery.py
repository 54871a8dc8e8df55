"""A cell, a configuration, a traffic kind and mix and a per-layer metric
are added as new files, and the harness finds them with no edit to any
file that was there."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import time

import torch

from conftest import BENCH, ROOT

from portbench.lib.harness import run_cell
from portbench.lib.registry import Cell, metric_readers

TOY_KIND = '''
import time
import torch
from portbench.lib.trace import Window


class Run:
    def __init__(self, cell, seed, device, variant=None, fault=None):
        self.n = cell.mix["items"]
        self.device = device

    def window(self, seconds, trace):
        with Window(trace, self.device) as w:
            x = torch.ones(self.n)
            s = float((x * 2).sum())
        return {"kind": "toy", "t0": w.t0, "attempted": self.n, "failed": 0, "missing": 0,
                "sum": s,
                "trace": w.trace, "e2e": {"toy_items_per_s": {"value": self.n / w.seconds,
                                                               "unit": "items/s"}}}

    def check(self):
        return [("toy_sum_error", 0.0, 0.0)]
'''

TOY_METRIC = '''
UNIT = "items"


def read(rec):
    return rec["sum"] / 2 if rec.get("kind") == "toy" else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_only(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "i3d_r50.json").read_text())
    cfg["name"] = "toy_model"
    (bench / "configs" / "toy_model.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "toy.py").write_text(TOY_KIND)
    (bench / "traffic" / "toy_mix.json").write_text(json.dumps({"kind": "toy", "items": 6}))
    (bench / "metrics" / "toy.half_sum.py").write_text(TOY_METRIC)
    (bench / "workloads" / "toy_model.toy.json").write_text(json.dumps(
        {"config": "toy_model", "traffic": "toy_mix", "chips": 1, "limits": {}}))
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before     # nothing edited

    cell = Cell("toy_model.toy", bench)
    assert cell.config["name"] == "toy_model" and cell.mix["kind"] == "toy"
    assert "toy.half_sum" in metric_readers(bench)
    out, checks = run_cell(cell, 2**40 + 3, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"] and set(out["metrics"]) == {"toy_items_per_s", "setup_s"}
    out, _ = run_cell(cell, 2**40 + 3, 0.1, True, torch.device("cpu"), time.perf_counter())
    assert out["metrics"]["toy.half_sum"] == {"value": 6.0, "unit": "items"}
    # the real cells' readers find nothing to read in a toy run
    assert not {"mfu.dense", "warp_affine_roofline", "host.step_ms.live"} & set(out["metrics"])


def test_the_command_refuses_without_a_card(tmp_path):
    """run.py prints no result and exits non-zero where no card is visible
    (here, always), also from a copy that holds only the benchmark's files."""
    if torch.cuda.is_available():
        return
    lone = tmp_path / "lone"
    shutil.copytree(BENCH, lone / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", lone / "BENCHMARK.json")
    for cwd in (ROOT, lone):
        res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "i3d_r50.dense",
                              "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and res.stdout.strip() == "", (cwd, res.stdout, res.stderr)
