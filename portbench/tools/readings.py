"""The output check's readings over many seeds, in one process.

    python3 portbench/tools/readings.py --workload i3d_r50.dense --seconds 10 \\
        --seeds 11 12 13 [--variant int8]

For each seed: one run of the cell as ``run.py`` makes it (set-up, window,
check), and one JSON line with the seed, ``correct``, the compared numbers
and the end-to-end metrics. Set-up times here are not a benchmark's: the
process is warm after the first seed. This is how the limits in
``workloads/<cell>.json`` were read (the sound program over a dozen seeds
or more, and the control, ``--variant``, over three or more).
"""

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from portbench.lib.device import require_cards
    import numpy as np

    from portbench.lib.harness import cache_dirs
    from portbench.lib.registry import BENCH_DIR, Cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", default=None)
    p.add_argument("--fault", default=None)
    a = p.parse_args()
    cache_dirs(BENCH_DIR.parent)
    cell = Cell(a.workload)
    device = require_cards(cell.chips)
    kind = cell.kind()
    for seed in a.seeds:
        run = kind.Run(cell, seed, device, variant=a.variant, fault=a.fault)
        rec = run.window(a.seconds, False)
        checks = run.check()
        line = {"workload": a.workload, "seed": seed, "variant": a.variant, "fault": a.fault,
                "failed": rec["failed"], "checks": {n: v for n, v, _ in checks},
                "metrics": {k: m["value"] for k, m in rec["e2e"].items()}}
        for attr in ("gaps", "steps"):
            v = getattr(run, attr, None)
            if v is not None and v.size:
                q = np.quantile(v, [0.5, 0.9, 1.0])
                line[attr] = {"n": int(v.size), "median": q[0], "p90": q[1], "max": q[2]}
        print(json.dumps(line), flush=True)
        del run
