"""What the program's spans (``stdd_torch/utils/spans.py``) cost and where a
trace shows them, on this machine: one JSON line.

    python3 portbench/tools/span_cost.py [--n 1000000]

- ``off_us``: one ``with span(...)`` with no profiler running, less the
  bare loop, in µs (the median of 5 rounds of ``--n``);
- ``on_us``: the same under a CPU profiler;
- ``all_threads``: whether a profiler started with ``profile_all_threads``
  (``utils/misc.py::profiler_trace``) records a span made on another
  thread, and ``one_thread``: whether a plain profiler does;
- with a card, ``mirrored``: the ``stdd.`` names among the trace's device
  events when a span brackets a kernel launch (none expected: a span is a
  plain ``cpu_op``), and ``mirrored_record_function`` the same for
  ``torch.profiler.record_function`` (a ``user_annotation``, for contrast).
"""

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path


def per_call_us(fn, n: int) -> float:
    t = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t) / n * 1e6


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    from stdd_torch.utils.spans import span

    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1_000_000)
    n = p.parse_args().n

    def spans(k):
        for _ in range(k):
            with span("stdd.cost"):
                pass

    def bare(k):
        for _ in range(k):
            pass

    out = {"torch": torch.__version__, "python": sys.version.split()[0]}
    rounds = [per_call_us(spans, n) - per_call_us(bare, n) for _ in range(5)]
    out["off_us"] = statistics.median(rounds)
    out["off_us_rounds"] = rounds
    with profile(activities=[ProfilerActivity.CPU]):
        m = min(n, 20_000)
        out["on_us"] = per_call_us(spans, m) - per_call_us(bare, m)

    def other_thread():
        with span("stdd.other_thread"):
            torch.ones(4).sum()

    for key, kw in (("one_thread", {}),
                    ("all_threads",
                     {"experimental_config": _ExperimentalConfig(profile_all_threads=True)})):
        with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
            t = threading.Thread(target=other_thread)
            t.start()
            t.join()
        out[key] = any(e.name() == "stdd.other_thread"
                       for e in prof.profiler.kineto_results.events())

    if torch.cuda.is_available():
        x = torch.ones(1 << 20, device="cuda")
        torch.cuda.synchronize()
        for key, ctx in (("mirrored", lambda: span("stdd.kernel")),
                         ("mirrored_record_function", lambda: record_function("stdd.kernel"))):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    with ctx():
                        x.mul_(1.0)
                torch.cuda.synchronize()
            out[key] = sorted({e.name() for e in prof.profiler.kineto_results.events()
                               if e.device_type() == torch.autograd.DeviceType.CUDA
                               and e.name().startswith("stdd.")})
        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
