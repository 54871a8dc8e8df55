"""How a traced live step divides among the program's spans, in one run.

    python3 portbench/tools/step_split.py --workload i3d_r50.live_grid --seed 7 \\
        --seconds 51

One traced window of the cell, as ``run.py --trace 1`` makes it (no output
check), and one JSON line:

- ``frames_per_s``: the traced window's rate (against an untraced run's,
  the profiler's cost);
- ``step_ms``: the mean ``step`` on the benchmark's clock, and
  ``step_span_ms`` the mean ``stdd.engine.step`` span;
- ``per_step_ms``: each stepping-thread span's total over the number of
  steps, and ``self_ms`` what no stage span covers (``lib/spans.py``);
- ``idle_in_steps_s``: device-idle time whose gap's middle falls inside a
  step, and ``named_by_stage``: the share of it whose innermost ``stdd.``
  span at that middle is a stage span rather than the step itself (every
  gap counts, not only the longest the result line's breakdown names).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def innermost_stdd(tr, t: np.ndarray):
    """For each time ``t`` (ns), the name of the shortest ``stdd.`` host
    span covering it, or None."""
    idx = [i for i, n in enumerate(tr.host_names) if n.startswith("stdd.")]
    s, e = tr.host_start[idx], tr.host_end[idx]
    names = [tr.host_names[i] for i in idx]
    out = []
    for x in t.tolist():
        inside = np.flatnonzero((s <= x) & (e >= x))
        out.append(names[inside[np.argmin(e[inside] - s[inside])]] if inside.size else None)
    return out


def split(rec) -> dict:
    from portbench.lib.spans import STEP, STEP_CHILDREN, intervals, per_step_ms, step_self_ms

    tr = rec["trace"]
    ss, se = intervals(tr, STEP)
    out = {"frames_per_s": rec["e2e"]["frames_per_s"]["value"],
           "step_ms": float(rec["step_ms"].mean()),
           "step_span_ms": float((se - ss).mean()) / 1e6 if ss.size else None,
           "steps": int(ss.size),
           "per_step_ms": {n: per_step_ms(rec, n) for n in STEP_CHILDREN},
           "self_ms": step_self_ms(rec)}
    _, gaps = tr._union()
    if gaps and ss.size:
        g = np.asarray(gaps, np.int64)
        mid = (g[:, 0] + g[:, 1]) // 2
        k = np.searchsorted(ss, mid, side="right") - 1
        in_step = (k >= 0) & (mid <= se[np.maximum(k, 0)])
        dur = (g[:, 1] - g[:, 0])[in_step]
        names = innermost_stdd(tr, mid[in_step])
        staged = np.asarray([n is not None and n != STEP for n in names], bool)
        by = {}
        for n, d in zip(names, dur.tolist()):
            by[n or "(none)"] = by.get(n or "(none)", 0) + d
        out.update(idle_in_steps_s=float(dur.sum()) / 1e9,
                   named_by_stage=float(dur[staged].sum() / max(dur.sum(), 1)),
                   idle_in_steps_by_span_s={n: v / 1e9 for n, v in
                                            sorted(by.items(), key=lambda kv: -kv[1])})
    return out


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from portbench.lib.device import require_cards
    from portbench.lib.harness import cache_dirs
    from portbench.lib.registry import BENCH_DIR, Cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    cache_dirs(BENCH_DIR.parent)
    cell = Cell(args.workload)
    device = require_cards(cell.chips)
    run = cell.kind().Run(cell, args.seed, device)
    try:
        rec = run.window(args.seconds, True)
    finally:
        run.close()
    if rec.get("kind") != "live":
        raise SystemExit(f"{args.workload} is not a live cell")
    print(json.dumps({"workload": args.workload, "seed": args.seed, **split(rec)}), flush=True)


if __name__ == "__main__":
    main()
