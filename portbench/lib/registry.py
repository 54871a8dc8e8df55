"""Finds a cell's files by the names ``BENCHMARK.json`` gives them.

- ``workloads/<cell>.json``: the cell's configuration, traffic mix and the
  limits of its output check;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<mix>.json``: the traffic mix, data only, with the ``kind`` of
  traffic it parameterises;
- ``traffic/<kind>.py``: the general generator and driver of that kind, a
  module with a ``Run(cell, seed, device, variant=None, fault=None)`` whose
  ``window(seconds, trace)`` returns the run's record (at least ``kind``,
  ``t0``, ``attempted``, ``failed``, ``missing``, ``trace`` and ``e2e``) and
  whose ``check()`` returns the compared numbers as (name, value, limit);
- ``metrics/<metric>.py``: one per-layer metric's reader, a module with a
  ``UNIT`` and a ``read(rec)`` that returns a number, or None where the run
  has nothing to read.

A cell, a configuration, a mix, a kind or a metric is added by adding its
file; no file here or elsewhere needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one ``--workload`` names, read from ``bench_dir``."""

    def __init__(self, name: str, bench_dir: Path = BENCH_DIR):
        self.name = name
        self.bench_dir = bench_dir
        path = bench_dir / "workloads" / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no workload file {path}")
        self.workload = load_json(path)
        self.config = load_json(bench_dir / "configs" / f"{self.workload['config']}.json")
        self.mix = load_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload.get("chips", 1))
        self.limits: Dict[str, float] = dict(self.workload.get("limits", {}))

    def kind(self) -> ModuleType:
        k = self.mix["kind"]
        return load_module(self.bench_dir / "traffic" / f"{k}.py", f"portbench_kind_{k}")


def metric_readers(bench_dir: Path = BENCH_DIR) -> Dict[str, ModuleType]:
    """Every per-layer reader, by metric name (the file name without ``.py``)."""
    out = {}
    for path in sorted((bench_dir / "metrics").glob("*.py")):
        name = path.name[:-3]
        if name.startswith("_"):
            continue
        out[name] = load_module(path, "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return out
