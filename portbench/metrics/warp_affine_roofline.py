"""K1's (``csrc/warp_affine.cu``) share of its roofline in the dense cells:
the least time the bytes the warp needs take at 3.35 TB/s (each frame's
I420 crop and 8 parameters read once, the aligned frame written once in
bf16; ``lib/flops.py``), over the time of the kernels named ``warp_affine``
in the trace. The arithmetic is far below the compute bound."""

from portbench.lib.flops import H100_HBM_BYTES_S

UNIT = "%"


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "dense" or tr is None:
        return None
    t = tr.seconds_where(lambda n: "warp_affine" in n)
    if t <= 0 or not rec.get("k1_launches"):
        return None
    return 100.0 * rec["k1_bytes"] / H100_HBM_BYTES_S / t
