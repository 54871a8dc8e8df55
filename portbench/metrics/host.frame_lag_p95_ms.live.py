"""The 95th percentile over every frame of the traced live window of how
late ``step`` took the frame up after it fell due on the open-loop
schedule: how far the host fell behind the calls."""

import numpy as np

UNIT = "ms"


def read(rec):
    if rec.get("kind") != "live" or rec.get("trace") is None or not len(rec["frame_lag_ms"]):
        return None
    return float(np.percentile(rec["frame_lag_ms"], 95))
