"""Misc utilities: parameter/FLOP counting, device memory, profiler scope,
rank-strided list sharding, resource sampling, dataset subsetting — the
reference's grab-bag (``slowfast/utils/misc.py``, ``utils/common.py:50``
skipShardSplit, ``demo.py:29`` UtilizationSampler, ``sample_subset.py``).

Port of ``stdd_tpu/utils/misc.py``:

- :func:`flop_count` counts with ``torch.utils.flop_counter.FlopCounterMode``
  over one call, where JAX asks XLA's cost analysis of the jitted function;
- :func:`device_mem_stats` reads ``torch.cuda.memory_allocated`` and
  ``max_memory_allocated``; :func:`profiler_trace` is a ``torch.profiler``
  scope over every thread, with CUDA activity on the card, exported as a
  chrome trace (the port's one trace exporter: the app's ``--profile``);
- ``enable_persistent_compilation_cache`` has no counterpart: it points
  XLA's compile cache at a directory, and eager PyTorch compiles nothing
  (the port's kernels are built once by ``utils/cuda_build.py`` and kept in
  ``stdd_torch/_build/``).
"""

from __future__ import annotations

import contextlib
import os
import random
import shutil
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def params_count(params) -> int:
    """Total parameter count (misc.py:params_count) of a module's
    parameters, or of every tensor in a state dict."""
    tensors = params.parameters() if isinstance(params, torch.nn.Module) else params.values()
    return sum(int(np.prod(p.shape)) for p in tensors)


def flop_count(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one ``fn(*args)`` call as PyTorch's flop counter counts them
    (2 per multiply-add of matmuls and convolutions) — the fvcore
    flop-analysis equivalent (misc.py:115 get_model_stats). None when the
    call fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            fn(*args)
    except (RuntimeError, TypeError, ValueError):
        return None
    return float(counter.get_total_flops())


def check_device(device: str, who: str) -> torch.device:
    """``device`` as a torch device; stops when it is the card and torch
    sees none (only ``--device cpu`` runs on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{who}: --device {device}, but torch sees no CUDA device; "
                         "pass --device cpu to run on the CPU")
    return dev


def device_mem_stats(device=None) -> Dict[str, float]:
    """Device memory in MB (the reference reads
    ``torch.cuda.max_memory_allocated``, TEST2.py:321); empty without a
    card."""
    if not torch.cuda.is_available():
        return {}
    return {
        "bytes_in_use_mb": torch.cuda.memory_allocated(device) / 2 ** 20,
        "peak_bytes_in_use_mb": torch.cuda.max_memory_allocated(device) / 2 ** 20,
    }


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """``torch.profiler`` trace scope (CPU, and CUDA activity when a card is
    present) written as ``trace.json`` under ``log_dir``; open it in Perfetto
    or ``chrome://tracing``. It records every thread (``profile_all_threads``),
    so the spans of the dispatch lanes and the detector's worker
    (``utils/spans.py``) are in the trace beside the stepping thread's.

    >>> with profiler_trace("/tmp/trace"):
    ...     probs = scorer.score(crops, boxes, lm5, valid)
    """
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def skip_shard_split(items: Sequence, rank: int, world: int) -> List:
    """Rank-strided sharding of a work list (utils/common.py:50
    skipShardSplit): item i goes to rank i % world."""
    return [x for i, x in enumerate(items) if i % world == rank]


class UtilizationSampler:
    """Background CPU/RSS sampler (demo.py:29). Uses psutil when present;
    degrades to RUSAGE."""

    def __init__(self, period_sec: float = 0.2):
        self.period = period_sec
        self.cpu: List[float] = []
        self.rss_mb: List[float] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _run(self):
        try:
            import psutil

            p = psutil.Process(os.getpid())
            while not self._stop.wait(self.period):
                try:
                    self.cpu.append(p.cpu_percent(interval=None))
                    self.rss_mb.append(p.memory_info().rss / 2 ** 20)
                except psutil.Error:
                    # per-sample errors (AccessDenied in restricted
                    # containers) must not kill the sampler thread silently
                    continue
        except ImportError:
            import resource

            while not self._stop.wait(self.period):
                ru = resource.getrusage(resource.RUSAGE_SELF)
                self.rss_mb.append(ru.ru_maxrss / 1024.0)

    def summary(self) -> Dict[str, float]:
        def s(a, f):
            return float(f(a)) if a else float("nan")

        return {
            "cpu_mean": s(self.cpu, np.mean),
            "rss_mb_mean": s(self.rss_mb, np.mean),
            "rss_mb_max": s(self.rss_mb, np.max),
        }


def sample_subset(
    src_root: str, dst_root: str, n_per_class: int, seed: int = 0,
    link: bool = True, exts=(".y4m", ".mp4", ".avi", ".mov", ".mkv"),
) -> Dict[str, int]:
    """Symlink/copy a balanced per-class video subset preserving relative
    paths (sample_subset.py:33-64); ``.y4m`` files, the port's video format,
    count too."""
    from ..eval.harness import classify_path

    pools: Dict[int, List[str]] = {0: [], 1: []}
    for dirpath, _, files in os.walk(src_root):
        for fn in files:
            if fn.lower().endswith(exts):
                p = os.path.join(dirpath, fn)
                lab = classify_path(p)
                if lab in pools:
                    pools[lab].append(p)
    rng = random.Random(seed)
    counts = {"real": 0, "fake": 0}
    for lab, key in ((0, "real"), (1, "fake")):
        pool = sorted(pools[lab])
        rng.shuffle(pool)
        for p in pool[:n_per_class]:
            rel = os.path.relpath(p, src_root)
            dst = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if os.path.exists(dst):
                continue
            if link:
                os.symlink(os.path.abspath(p), dst)
            else:
                shutil.copy2(p, dst)
            counts[key] += 1
    return counts
