"""The live knee: the highest load the server sustains, one load at a time.

    python3 portbench/tools/sweep.py --workload i3d_r50.live_grid --seed 5 \\
        --seconds 20 --calls 1 --fps 18 22 26 30

For each count of calls and each frame rate, one window of the cell's
traffic with ``calls`` and ``fps`` set to them, and one JSON line: the
frame lag (p50, p95, and its mean over the window's first and last
quarters, which shows a growing backlog), the step time, the window
latency and the failures. A load is sustained when the frame lag's p95
stays under one frame period and the last quarter's lag is no larger than
the first's by more than a period. The cell's own load is four fifths of
the highest sustained.
"""

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np

    from portbench.lib.device import require_cards
    from portbench.lib.harness import cache_dirs
    from portbench.lib.registry import BENCH_DIR, Cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--calls", type=int, nargs="+", required=True)
    p.add_argument("--fps", type=float, nargs="+", default=None)
    a = p.parse_args()
    cache_dirs(BENCH_DIR.parent)
    cell = Cell(a.workload)
    device = require_cards(cell.chips)
    kind = cell.kind()
    for calls, fps in [(c, f) for c in a.calls for f in (a.fps or [cell.mix["fps"]])]:
        cell.mix.update(calls=calls, fps=fps)
        run = kind.Run(cell, a.seed, device)
        rec = run.window(a.seconds, False)
        run.close()
        lag, lat = rec["frame_lag_ms"], rec["latency_ms"]
        q = max(1, len(lag) // 4)
        period = 1000.0 / cell.mix["fps"]
        line = {"calls": calls, "fps": fps, "frames": int(len(lag)), "windows": rec["windows"],
                "failed": rec["failed"],
                "frame_lag_p50_ms": float(np.percentile(lag, 50)),
                "frame_lag_p95_ms": float(np.percentile(lag, 95)),
                "lag_first_quarter_ms": float(lag[:q].mean()),
                "lag_last_quarter_ms": float(lag[-q:].mean()),
                "step_ms_mean": float(rec["step_ms"].mean()),
                "window_latency_p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "window_latency_p95_ms": float(np.percentile(lat, 95)) if lat.size else None}
        line["sustained"] = bool(line["frame_lag_p95_ms"] < period and
                                 line["lag_last_quarter_ms"] - line["lag_first_quarter_ms"] < period)
        print(json.dumps(line), flush=True)
        del run
