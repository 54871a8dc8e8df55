"""FTCN-TT's time-transformer head in the dense cells: the mean of the
program's ``stdd.scorer.head`` spans in the traced window (inside
``stdd.scorer.trunk``: the token pool, the encoder layer, the cls token's
LayerNorm and the last linear layer, as the host launches them). A model
without that head (the I3D) records no such span and reads nothing."""

from portbench.lib.spans import mean_ms

UNIT = "ms"


def read(rec):
    return mean_ms(rec, "dense", "stdd.scorer.head")
