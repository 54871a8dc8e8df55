"""What moves a cell's rate from run to run: one run of the cell's window
(no output check), with the host's own readings around it.

    python3 portbench/tools/spread.py --workload i3d_r50.live_grid --seed 5 \\
        --seconds 51 [--gc-freeze] [--threads N] [--switch-ms MS]

One JSON line: the end-to-end metrics; the step time over ten equal parts
of the window (a slow part shows a transient, an even shift a slow run);
the process's CPU seconds and context switches (``getrusage``), each
thread's CPU seconds by name and id; the whole machine's CPU shares over the
window from ``/proc/stat`` (``steal`` is time the hypervisor gave to
others); and the garbage collector's passes and pause time by generation.
The options try a remedy in this process alone: ``--gc-freeze`` moves
every object made in set-up out of the collector's reach
(``gc.freeze()``), ``--threads`` sets PyTorch's intra-op threads,
``--switch-ms`` the interpreter's thread switch interval.
"""

import argparse
import gc
import json
import os
import resource
import sys
import time
from pathlib import Path


def cpu_times():
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:9]]
    return dict(zip(("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal"), v))


def thread_cpu():
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                s = f.read()
        except OSError:
            continue
        name = s[s.index("(") + 1:s.rindex(")")]
        fields = s.rsplit(")", 1)[1].split()
        out[(tid, name)] = (int(fields[11]) + int(fields[12])) / tick
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch

    from portbench.lib.device import require_cards
    from portbench.lib.harness import cache_dirs, process_start_perf
    from portbench.lib.registry import BENCH_DIR, Cell

    t_start = process_start_perf()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--gc-freeze", action="store_true")
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--switch-ms", type=float, default=None)
    a = p.parse_args()
    cache_dirs(BENCH_DIR.parent)
    if a.threads:
        torch.set_num_threads(a.threads)
    if a.switch_ms:
        sys.setswitchinterval(a.switch_ms / 1000.0)
    cell = Cell(a.workload)
    device = require_cards(cell.chips)
    run = cell.kind().Run(cell, a.seed, device)
    if a.gc_freeze:
        gc.collect()
        gc.freeze()

    gc_pass = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
    gc_t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            g = gc_pass[info["generation"]]
            g[0] += 1
            g[1] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(on_gc)
    ru0, cpu0, th0 = resource.getrusage(resource.RUSAGE_SELF), cpu_times(), thread_cpu()
    rec = run.window(a.seconds, False)
    ru1, cpu1, th1 = resource.getrusage(resource.RUSAGE_SELF), cpu_times(), thread_cpu()
    gc.callbacks.remove(on_gc)
    run.close()

    step = rec["step_ms"]
    parts = [float(x.mean()) for x in np.array_split(step, 10)] if step.size >= 10 else []
    d = {k: cpu1[k] - cpu0[k] for k in cpu0}
    tot = max(1, sum(d.values()))
    threads = {}
    for key, v in th1.items():
        dv = v - th0.get(key, 0.0)
        if dv >= 0.05:
            threads[f"{key[1]}/{key[0]}"] = round(dv, 2)
    line = {
        "workload": a.workload, "seed": a.seed, "gc_freeze": a.gc_freeze, "threads": a.threads,
        "switch_ms": a.switch_ms, "torch_threads": torch.get_num_threads(),
        "cpus": len(os.sched_getaffinity(0)),
        "setup_s": rec["t0"] - t_start, "window_s": rec["window_s"],
        "metrics": {k: m["value"] for k, m in rec["e2e"].items()},
        "step_ms_mean": float(step.mean()) if step.size else None,
        "step_ms_p50_p90_p99": [float(x) for x in np.percentile(step, [50, 90, 99])]
        if step.size else None,
        "step_ms_tenths": parts,
        "cpu_s": {"user": ru1.ru_utime - ru0.ru_utime, "system": ru1.ru_stime - ru0.ru_stime},
        "ctx_switches": {"voluntary": ru1.ru_nvcsw - ru0.ru_nvcsw,
                         "involuntary": ru1.ru_nivcsw - ru0.ru_nivcsw},
        "thread_cpu_s": dict(sorted(threads.items(), key=lambda kv: -kv[1])),
        "machine_cpu_share": {k: v / tot for k, v in d.items()},
        "gc": {str(g): {"passes": n, "pause_s": s} for g, (n, s) in gc_pass.items()},
        "loadavg": open("/proc/loadavg").read().split()[:3],
    }
    print(json.dumps(line), flush=True)
