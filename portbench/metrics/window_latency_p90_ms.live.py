"""The 90th percentile of enqueue → scored over every window the traced
live window scored: the program's own ``MultiStreamServer.clip_latencies``
(the reference's TEST2 accounting, stamped on the dispatch lane when the
score is routed). The live cell runs above the server's knee, where the
rate completed is the end-to-end number and latencies are read per layer;
the frames' backlog does not enter this one, which starts at the enqueue."""

import numpy as np

UNIT = "ms"


def read(rec):
    if rec.get("kind") != "live" or rec.get("trace") is None or not len(rec["latency_ms"]):
        return None
    return float(np.percentile(rec["latency_ms"], 90))
