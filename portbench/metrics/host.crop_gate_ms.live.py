"""Cropping and gating of a live step, per step: the program's
``stdd.engine.crop_gate`` spans (for each tracked face: landmarks, crop box,
the crop's copy and channel flip, the Laplacian quality gate) summed over
the traced window, over its ``stdd.engine.step`` spans."""

from portbench.lib.spans import per_step_ms

UNIT = "ms"


def read(rec):
    return per_step_ms(rec, "stdd.engine.crop_gate")
