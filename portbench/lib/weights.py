"""Seeded weights of an I3D-ResNet, made on the device in a few calls.

One ``torch.randn`` over every convolution weight and one over every batch
norm's four vectors, drawn from a ``torch.Generator`` on ``device`` and
seeded with ``--seed``, then cut into views and scaled. The served model
keeps float32 parameters (it casts to bf16 per convolution), so they are
made in float32.

The draw keeps activations near unit scale through the depth, so the head's
logit stays well inside float32's resolution of a sigmoid; every layer
contributes (a zero-initialised residual scale would leave most of the
trunk out of the output); and the channels' scales spread over an order of
magnitude, as a trained network's do, so a per-tensor integer quantisation
of the activations costs what it costs in a deployment:

- convolutions: normal, standard deviation sqrt(2 / fan_in);
- batch norm: scale exp(z - 1), whose mean square is 1 (times 0.3 on a
  residual branch's last one), shift 0.02 z, running mean 0.02 z, running
  variance 1 + 0.1 |z|. Larger shifts make the deep features nearly the
  same for every input, and the output all but ignore the clip;
- head: normal with standard deviation 0.5 / sqrt(features), bias 0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.i3d import NetSpec, conv_specs


def make_i3d_params(spec: NetSpec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the served model's state dict, by name."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    convs = list(conv_specs(spec))
    shapes = [(c.cout, c.cin) + c.kernel for c in convs]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    chans = sum(c.cout for c in convs)
    bn = torch.randn(4, chans, generator=gen, device=device)
    head = torch.randn(spec.num_classes, spec.head_in, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = ch = 0
    for c, shape, n in zip(convs, shapes, sizes):
        fan_in = c.cin * math.prod(c.kernel)
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
    out["head.projection.weight"] = head * (0.5 / math.sqrt(spec.head_in))
    out["head.projection.bias"] = torch.zeros(spec.num_classes, device=device)
    return out
