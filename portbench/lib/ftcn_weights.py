"""Seeded weights of FTCN-TT, made on the device in a few calls.

The trunk follows ``lib/weights.py``'s rules, for the reasons given there:
one ``torch.randn`` over every convolution weight (normal, standard
deviation sqrt(2 / fan_in)) and one over every batch norm's four vectors
(scale exp(z - 1), times 0.3 on a residual branch's last one; shift
0.02 z; running mean 0.02 z; running variance 1 + 0.1 |z|).

The head, from one more ``torch.randn``:

- Dense layers: normal with standard deviation 1 / sqrt(fan_in), so each
  layer keeps its input's scale and the logit's spread over random heads
  is about one; their biases 0.02 z, ``head_fc``'s 0;
- LayerNorms near (1, 0): scale 1 + 0.1 z, shift 0.02 z;
- the cls token and the positional embedding 0.02 z, small beside the time
  tokens (the trunk's activations, near unit scale), so that the tokens,
  and so the clip, decide the logit.

Everything is float32: the served model keeps float32 parameters.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.ftcn import FTCNSpec, head_shapes, tconvs


def make_ftcn_params(spec: FTCNSpec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the served FTCN's state dict, by name."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    convs = list(tconvs(spec))
    shapes = [(c.cout, c.cin, c.kt, 1, 1) for c in convs]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    bn = torch.randn(4, sum(c.cout for c in convs), generator=gen, device=device)
    heads = head_shapes(spec.head)
    hflat = torch.randn(sum(math.prod(s) for s in heads.values()), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = ch = 0
    for c, shape, n in zip(convs, shapes, sizes):
        fan_in = c.cin * c.kt
        out[c.name + ".conv.weight"] = flat[off:off + n].view(shape) * math.sqrt(2.0 / fan_in)
        z = bn[:, ch:ch + c.cout]
        g = torch.exp(z[0] - 1.0)
        out[c.name + ".bn.weight"] = 0.3 * g if c.residual_end else g
        out[c.name + ".bn.bias"] = 0.02 * z[1]
        out[c.name + ".bn.running_mean"] = 0.02 * z[2]
        out[c.name + ".bn.running_var"] = 1.0 + 0.1 * z[3].abs()
        out[c.name + ".bn.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
        off += n
        ch += c.cout
    off = 0
    for name, shape in heads.items():
        n = math.prod(shape)
        z = hflat[off:off + n].view(shape)
        off += n
        if name == "head.head_fc.bias":
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith(".weight") and len(shape) == 2:           # a Dense layer
            out[name] = z / math.sqrt(shape[1])
        elif "norm" in name and name.endswith(".weight"):
            out[name] = 1.0 + 0.1 * z
        else:                                     # biases, LayerNorm shifts, tokens
            out[name] = 0.02 * z
    return out
