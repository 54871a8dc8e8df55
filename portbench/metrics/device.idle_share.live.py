"""The share of the traced live window in which no operation ran on the
card: 1 − (union of the device operations' intervals) / window."""

UNIT = "%"


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "live" or tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
