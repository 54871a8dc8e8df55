"""Packing of a live step, per step: the program's ``stdd.ring.pack``
spans (for each face, the crop's area downscale into its ring slot and the
I420 encode) summed over the traced window, over its ``stdd.engine.step``
spans."""

from portbench.lib.spans import per_step_ms

UNIT = "ms"


def read(rec):
    return per_step_ms(rec, "stdd.ring.pack")
