"""Program spans: named host intervals at the port's layer boundaries, on
the profiler's clock.

``with span("stdd.engine.track"): ...`` records a plain ``cpu_op`` event
through ``torch._C._profiler._RecordFunctionFast`` while a
``torch.profiler`` session is on, and does nothing but read one flag
otherwise. It is the only way the port records spans:

- the profiler's user-annotation ranges cost more with no profiler
  running, and kineto mirrors them onto the device timeline, where they
  would count as device work;
- kineto stamps host events on the clock it stamps device activities on,
  so a span lines up with the kernels of the same trace as it is.

A profiler records the spans of the thread it was started on, and those of
every thread only with ``profile_all_threads``
(``utils/misc.py::profiler_trace`` turns it on).

Names start with ``stdd.`` and never contain ``warp_affine`` (a kernel
name the benchmark selects device operations by).
"""

from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` while a profiler is on."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)
