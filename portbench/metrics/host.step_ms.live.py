"""Mean wall time of one ``MultiStreamServer.step`` call in the traced live
window, on the benchmark's clock (the host plane: tracking, gating, crop,
I420 pack, ring push, dispatch and routing on the stepping thread)."""

UNIT = "ms"


def read(rec):
    if rec.get("kind") != "live" or rec.get("trace") is None or not len(rec["step_ms"]):
        return None
    return float(rec["step_ms"].mean())
