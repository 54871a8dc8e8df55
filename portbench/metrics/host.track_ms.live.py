"""Tracking's share of a live step, per step: the program's
``stdd.engine.track`` spans (the detection filter, ``ByteTracker.update``
and the id-switch accounting) summed over the traced window, over its
``stdd.engine.step`` spans."""

from portbench.lib.spans import per_step_ms

UNIT = "ms"


def read(rec):
    return per_step_ms(rec, "stdd.engine.track")
