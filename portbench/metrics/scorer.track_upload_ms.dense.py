"""A track's upload in the dense cells: the mean of the program's
``stdd.scorer.upload`` spans in the traced window (inside
``ClipScorer.score_dense``, the track's frames, boxes and landmarks
through pinned memory to the card, and the window index)."""

from portbench.lib.spans import mean_ms

UNIT = "ms"


def read(rec):
    return mean_ms(rec, "dense", "stdd.scorer.upload")
