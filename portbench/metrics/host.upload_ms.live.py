"""Ring uploads of a live step, per step: the program's ``stdd.ring.upload``
spans (a staged group's pinned copy, host-to-device copy and
``index_copy_``, submitted on the rings' stream) summed over the traced
window, over its ``stdd.engine.step`` spans."""

from portbench.lib.spans import per_step_ms

UNIT = "ms"


def read(rec):
    return per_step_ms(rec, "stdd.ring.upload")
