"""The program's own spans (``stdd_torch/utils/spans.py``) in a traced window.

The port records a ``stdd.`` span at each layer boundary of the live step
and the scorer; ``lib/trace.py`` keeps every host event the profiler saw
(the stepping thread's: the profiler records the thread it was started on)
as ``host_names``, ``host_start`` and ``host_end`` (ns). The readers here
return None where the run has no trace or the program records no spans
(a program older than its spans).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

STEP = "stdd.engine.step"
# the stepping thread's spans inside a step: what a step's self time leaves out
STEP_CHILDREN = ("stdd.engine.detect", "stdd.engine.track", "stdd.engine.crop_gate",
                 "stdd.ring.pack", "stdd.ring.upload", "stdd.engine.emit",
                 "stdd.dispatch.tick")


def intervals(tr, *names: str) -> Tuple[np.ndarray, np.ndarray]:
    """(start ns, end ns) of the host spans named ``names``, by start."""
    mask = np.fromiter((n in names for n in tr.host_names), bool, len(tr.host_names))
    s, e = tr.host_start[mask], tr.host_end[mask]
    order = np.argsort(s, kind="stable")
    return s[order], e[order]


def _traced(rec, kind: str):
    tr = rec.get("trace")
    if rec.get("kind") != kind or tr is None:
        return None
    return tr


def per_step_ms(rec, name: str) -> Optional[float]:
    """Total time of the spans ``name`` in a traced live window over the
    number of steps (``stdd.engine.step`` spans), in ms."""
    tr = _traced(rec, "live")
    if tr is None:
        return None
    steps = intervals(tr, STEP)[0].size
    if not steps:
        return None
    s, e = intervals(tr, name)
    return float((e - s).sum()) / 1e6 / steps


def mean_ms(rec, kind: str, name: str) -> Optional[float]:
    """Mean duration of the spans ``name`` in a traced window of ``kind``, in ms."""
    tr = _traced(rec, kind)
    if tr is None:
        return None
    s, e = intervals(tr, name)
    if not s.size:
        return None
    return float((e - s).mean()) / 1e6


def step_self_ms(rec) -> Optional[float]:
    """Mean over the steps of a traced live window of a step's duration less
    the union of its child spans (``STEP_CHILDREN``, which nest: the upload
    runs inside a window's emit), in ms."""
    tr = _traced(rec, "live")
    if tr is None:
        return None
    ss, se = intervals(tr, STEP)
    if not ss.size:
        return None
    cs, ce = intervals(tr, *STEP_CHILDREN)
    covered = np.zeros(ss.size, np.int64)
    if cs.size:
        # merge the children into disjoint intervals, then give each to the
        # step it starts in (steps run one after another on one thread)
        run_end = np.maximum.accumulate(ce)
        new = np.ones(cs.size, bool)
        new[1:] = cs[1:] > run_end[:-1]
        idx = np.flatnonzero(new)
        ms, me = cs[new], run_end[np.r_[idx[1:] - 1, cs.size - 1]]
        k = np.searchsorted(ss, ms, side="right") - 1
        inside = (k >= 0) & (me <= se[np.maximum(k, 0)])
        np.add.at(covered, k[inside], (me - ms)[inside])
    return float(((se - ss) - covered).mean()) / 1e6
