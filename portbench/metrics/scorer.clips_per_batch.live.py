"""Windows scored per scorer batch in the traced live window: windows over
K1 launches (``warp_affine.launches`` counts one a batch)."""

UNIT = "clips"


def read(rec):
    if rec.get("kind") != "live" or rec.get("trace") is None or not rec.get("k1_launches"):
        return None
    return rec["windows_scored"] / rec["k1_launches"]
