"""The measured window, and what ``torch.profiler`` saw in it.

``Window`` brackets the timed part of a run. With ``trace`` it runs
``torch.profiler`` (CPU and CUDA activities) over the window and, after it,
keeps the device's operations (kernels, copies, sets) and the host's spans
as plain arrays for the per-layer readers:

- ``busy_s``: the union of the device operations' intervals, in seconds
  (the device's busy time, whatever the streams; summing durations would
  count overlapping streams twice);
- ``device_ops``: seconds by operation name, largest first;
- ``idle_gaps``: the gaps between device operations, each named by the
  innermost host span that covers its middle, seconds summed by that name,
  largest first.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# the benchmark's own host spans (``torch.profiler.record_function`` names)
SPAN_PREFIX = "portbench."


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")()) * 1000


class Window:
    """``with Window(trace) as w: ...`` → ``w.seconds`` (host clock, the
    device synchronised at both ends) and, traced, ``w.trace``."""

    def __init__(self, trace: bool, device):
        self.traced = trace
        self.cuda = torch.device(device).type == "cuda"
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.seconds = self.t1 - self.t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = Trace.from_profiler(self._prof, self.seconds)
            self._prof = None
        return False


class Trace:
    """Device operations and host spans of one traced window."""

    def __init__(self, dev_names: List[str], dev_start: np.ndarray, dev_end: np.ndarray,
                 dev_stream: np.ndarray, host_names: List[str], host_start: np.ndarray,
                 host_end: np.ndarray, window_s: float):
        self.dev_names, self.dev_start, self.dev_end = dev_names, dev_start, dev_end
        self.dev_stream = dev_stream
        self.host_names, self.host_start, self.host_end = host_names, host_start, host_end
        self.window_s = window_s

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        dn, ds, de, dst, hn, hs, he = [], [], [], [], [], [], []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.name().startswith(SPAN_PREFIX):
                    continue          # the benchmark's own host span, mirrored on the device's timeline
                dn.append(e.name())
                ds.append(start)
                de.append(end)
                dst.append(e.device_resource_id())
            else:
                hn.append(e.name())
                hs.append(start)
                he.append(end)
        return cls(dn, np.asarray(ds, np.int64), np.asarray(de, np.int64),
                   np.asarray(dst, np.int64), hn, np.asarray(hs, np.int64),
                   np.asarray(he, np.int64), window_s)

    # -- device time ----------------------------------------------------------

    def _union(self, mask: Optional[np.ndarray] = None) -> Tuple[float, List[Tuple[int, int]]]:
        """(busy seconds, idle gaps as (start ns, end ns)) of the device
        operations selected by ``mask``."""
        s, e = self.dev_start, self.dev_end
        if mask is not None:
            s, e = s[mask], e[mask]
        if s.size == 0:
            return 0.0, []
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        run_end = np.maximum.accumulate(e)
        # a new busy interval starts where an operation begins after every
        # earlier one has ended
        new = np.ones(s.size, bool)
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = run_end[np.r_[idx[1:] - 1, s.size - 1]]
        busy = float((ends - starts).sum()) / 1e9
        gaps = list(zip(ends[:-1].tolist(), starts[1:].tolist()))
        return busy, gaps

    @property
    def busy_s(self) -> float:
        return self._union()[0]

    def seconds_where(self, pred) -> float:
        """Summed duration of the device operations whose name satisfies
        ``pred`` (operations of one name do not overlap one another on a
        stream)."""
        mask = np.fromiter((bool(pred(n)) for n in self.dev_names), bool, len(self.dev_names))
        return float((self.dev_end[mask] - self.dev_start[mask]).sum()) / 1e9

    def seconds_on_streams(self, streams) -> float:
        """Summed duration of the device operations on ``streams`` (one
        stream runs its operations one at a time)."""
        mask = np.isin(self.dev_stream, np.asarray(list(streams), np.int64))
        return float((self.dev_end[mask] - self.dev_start[mask]).sum()) / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for n, s, e in zip(self.dev_names, self.dev_start.tolist(), self.dev_end.tolist()):
            by[n] = by.get(n, 0) + (e - s)
        best = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], v / 1e9] for n, v in best]

    def idle_gaps(self, top: int = 10, longest: int = 2000) -> List[List]:
        """The ``longest`` gaps, each named by the innermost host span over
        its middle; seconds summed by name, the ``top`` largest."""
        _, gaps = self._union()
        gaps.sort(key=lambda g: g[0] - g[1])
        by: Dict[str, int] = {}
        hs, he = self.host_start, self.host_end
        for a, b in gaps[:longest]:
            mid = (a + b) // 2
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            if inside.size:
                k = inside[np.argmin(he[inside] - hs[inside])]
                name = self.host_names[k]
            else:
                name = "(no host span)"
            by[name] = by.get(name, 0) + (b - a)
        best = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], v / 1e9] for n, v in best]
