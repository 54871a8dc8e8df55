"""One run of one cell: set up, measure, check, print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up: the cell's kind builds the program's objects, makes the weights
   and inputs from ``--seed`` and warms every shape the traffic uses.
   ``setup_s`` runs from the process's start to the first timed call.
2. The window: ``--seconds`` of traffic (``--trace 1``: under
   ``torch.profiler``).
3. The check: the program's state is freed and the plain reference
   (``portbench/reference``) recomputes a sample of the window's outputs;
   each compared number is printed beside its limit.
4. The result: the last line of standard output, one JSON object. With
   ``--trace 0`` its metrics are the cell's end-to-end ones, with
   ``--trace 1`` the per-layer ones.

The run fails (exit code other than 0, no result line) without enough
cards, or when the JAX side (``lib/guard.py``) was imported.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

from . import guard
from .registry import BENCH_DIR, Cell, metric_readers


def process_start_perf() -> float:
    """``time.perf_counter()`` of this process's start, from /proc (10 ms
    resolution); the interpreter's own start-up counts as set-up."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def cache_dirs(root: Path) -> None:
    """Every kernel or extension cache the program may use, at fixed places
    inside the checkout (the K1 library builds in ``stdd_torch/_build``,
    which the program fixes there itself)."""
    base = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", default=None,
                   help="run the program with one of its own lower-precision paths "
                        "(the output check's control); never set in a benchmark run")
    return p.parse_args(argv)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, variant: Optional[str] = None, fault: Optional[str] = None):
    """Set up, measure and check one cell → (result dict, checks). The
    caller has made sure of the device."""
    import torch

    kind = cell.kind()
    run = kind.Run(cell, seed, device, variant=variant, fault=fault)
    rec = run.window(seconds, trace)
    rec["setup_s"] = rec["t0"] - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    checks = run.check()
    del run
    gc.collect()
    # a late answer counts as failed, not as wrong: only one that never
    # came (or came non-finite) and the compared numbers decide `correct`
    correct = rec["missing"] == 0 and all(v <= lim for _, v, lim in checks)
    if trace:
        metrics = {}
        for name, reader in metric_readers(cell.bench_dir).items():
            v = reader.read(rec)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": reader.UNIT}
    else:
        metrics = dict(rec["e2e"])
        metrics["setup_s"] = {"value": rec["setup_s"], "unit": "s"}
    out = {"correct": bool(correct), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics}
    out["device"] = {"memory_peak_bytes": int(peak)}
    if trace and rec.get("trace") is not None:
        tr = rec["trace"]
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    return out, checks


def main(argv: Optional[List[str]] = None) -> int:
    t_start = process_start_perf()
    args = parse(argv)
    root = BENCH_DIR.parent
    cache_dirs(root)
    cell = Cell(args.workload)

    from .device import NoCard, describe, require_cards

    try:
        device = require_cards(cell.chips)
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    out, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start,
                           variant=args.variant)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"portbench: the process imported {bad}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    dev = describe(cell.chips)
    dev.update(out["device"])
    out["device"] = dev
    if args.variant:
        out["variant"] = args.variant
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
