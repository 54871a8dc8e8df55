"""The shape-based work counts against PyTorch's own counter."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH

from portbench.lib.flops import i3d_flops, k1_bytes_per_frame
from portbench.lib.weights import make_i3d_params
from portbench.reference.i3d import forward, net_spec


@pytest.mark.parametrize("name", ["i3d_r50"])
def test_flops_match_the_counter_on_the_reference(name):
    """Full widths, a small clip: every convolution and the head, exactly."""
    model = json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]
    model.update(num_frames=4, crop_size=32)
    spec = net_spec(model)
    params = make_i3d_params(spec, 7, "cpu")
    x = torch.randn(1, 3, spec.frames, spec.crop, spec.crop)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        forward(params, x, spec)
    assert fc.get_total_flops() == i3d_flops(spec)


def test_the_i3d_window_against_the_hand_count():
    """114 GMAC a 32x224x224 window, counted by hand from the layer shapes;
    the exact count is 113.63 GMAC."""
    spec = net_spec(json.loads((BENCH / "configs" / "i3d_r50.json").read_text())["model"])
    assert i3d_flops(spec) == 227_254_734_848
    assert abs(i3d_flops(spec) / 2 / 114e9 - 1) < 0.01


def test_k1_bytes():
    # I420 256x256 in, 8 float32 parameters, 224x224x3 bf16 out
    assert k1_bytes_per_frame(256, 224) == 98_304 + 32 + 301_056
