"""The card a run measures: refuse to run without one, and describe it."""

from __future__ import annotations

import subprocess
import sys

import torch


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> torch.device:
    """The first card, once ``n`` cards are visible; otherwise :class:`NoCard`.
    A run never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs only on a card")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} card(s); torch.cuda.device_count() is {have}")
    return torch.device("cuda", 0)


def power_limit_w() -> "float | None":
    """The first card's power limit in watts, from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError) as e:
        print(f"portbench: power limit not read: {e!r}", file=sys.stderr)
        return None


def describe(count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "power_limit_w": power_limit_w()}
