"""Detection's share of a live step, per step: the program's
``stdd.engine.detect`` spans (the call into the detector on a detect frame;
through ``AsyncDetector``, the wait for the previous detection and the
submit of this one) summed over the traced window, over its
``stdd.engine.step`` spans."""

from portbench.lib.spans import per_step_ms

UNIT = "ms"


def read(rec):
    return per_step_ms(rec, "stdd.engine.detect")
