"""Device time a detection: every device operation on the detectors' own
streams in the traced live window (frame upload, resize, the graph, the
decode), over the detections made in the window. The streams are the ones
a detection profiled alone before the window ran on (``detector_streams``
in the run's record), so the reading does not hang on any kernel's name."""

UNIT = "ms"


def read(rec):
    tr = rec.get("trace")
    streams = rec.get("detector_streams")
    if rec.get("kind") != "live" or tr is None or not streams or not rec.get("detections"):
        return None
    return 1000.0 * tr.seconds_on_streams(streams) / rec["detections"]
