"""K3's device time for one scored window in the dense cells: the summed
duration of the kernels whose name holds ``bias_act`` in the traced window
(the pass that adds eval BatchNorm's shift, the residual and the ReLU after
each convolution with BN folded into its weight), in ms, over the windows
scored. A program without that kernel reads nothing."""

UNIT = "ms"


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "dense" or tr is None or not rec.get("clips"):
        return None
    t = tr.seconds_where(lambda n: "bias_act" in n)
    if t <= 0:
        return None
    return 1000.0 * t / rec["clips"]
