"""The dense scoring step's share of the card's bf16 peak: the model FLOPs of
every window the traced window scored (counted from the configuration's
shapes, ``lib/flops.py``) over the window's time, against 989 TFLOP/s (H100
SXM, dense bf16, at 700 W; the card's power limit is in the result's
``device``)."""

from portbench.lib.flops import H100_BF16_FLOPS

UNIT = "%"


def read(rec):
    if rec.get("kind") != "dense" or rec.get("trace") is None or rec["trace"].busy_s <= 0:
        return None
    return 100.0 * rec["flops_per_clip"] * rec["clips"] / rec["window_s"] / H100_BF16_FLOPS
