"""The part of a live step that no stage span names: the mean over the
traced window's ``stdd.engine.step`` spans of each one's duration less the
union of the stepping thread's spans inside it (detect, track, crop_gate,
pack, upload, emit and the dispatch tick; ``lib/spans.py``)."""

from portbench.lib.spans import step_self_ms

UNIT = "ms"


def read(rec):
    return step_self_ms(rec)
