"""The two re-laid convolutions that ``Conv3dBN`` runs on the card in 16
bits, the stems' space-to-depth (``models/i3d.py::space_to_depth_conv3d``)
and the ``[kt, 1, 1]`` kernel as a 2D convolution
(``temporal_conv3d_as_2d``), against the plain convolution, in float64 on
the CPU: the forward and the gradients with respect to the input and the
weight within 1e-12. On the CPU ``Conv3dBN`` keeps the plain convolution in
every dtype and counts no re-laid one; the card's side is in
``tests/test_torch_cuda.py``."""

import pytest
import torch
import torch.nn.functional as F

from stdd_torch.models.i3d import (Conv3dBN, fits_space_to_depth, fits_temporal_2d,
                                   space_to_depth_conv3d, temporal_conv3d_as_2d)

# (C, T, H, W, features, kernel, stride, padding)
CASES = {
    "stem_t3": (3, 4, 16, 16, 8, (3, 7, 7), (1, 2, 2), (1, 3, 3)),
    "stem_t5_rect": (3, 4, 16, 12, 8, (5, 7, 7), (1, 2, 2), (2, 3, 3)),
    "c5_t_stride": (5, 4, 8, 8, 6, (1, 3, 3), (2, 2, 2), (0, 1, 1)),
    "c3_1x1": (3, 2, 8, 10, 4, (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    "c3_even_kernel": (3, 2, 12, 8, 4, (1, 4, 4), (1, 2, 2), (0, 1, 1)),
    "c2_even_pad": (2, 2, 12, 12, 4, (1, 7, 7), (1, 2, 2), (0, 2, 2)),
}


# (C, T, H, W, features, kernel, stride, padding, channels_last_3d input)
TEMPORAL_CASES = {
    "s2_a": (16, 6, 5, 4, 8, (3, 1, 1), (1, 1, 1), (1, 0, 0), True),
    "ftcn_stem": (3, 8, 4, 6, 8, (5, 1, 1), (1, 1, 1), (2, 0, 0), True),
    "f2s_t_stride": (8, 8, 3, 3, 16, (7, 1, 1), (4, 1, 1), (3, 0, 0), True),
    "contiguous_in": (8, 5, 4, 4, 8, (3, 1, 1), (1, 1, 1), (1, 0, 0), False),
}


def _against_the_plain_conv(conv, C, T, H, W, co, kernel, stride, padding, cl=True):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, C, T, H, W, generator=g, dtype=torch.float64)
    if cl:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    x.requires_grad_(True)
    w = torch.randn((co, C) + kernel, generator=g, dtype=torch.float64, requires_grad=True)
    ref = F.conv3d(x, w, None, stride, padding)
    y = conv(x, w, stride, padding)
    assert y.shape == ref.shape
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)
    dy = torch.randn(ref.shape, generator=g, dtype=torch.float64)
    gx_ref, gw_ref = torch.autograd.grad(ref, (x, w), dy)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    torch.testing.assert_close(gx, gx_ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gw, gw_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_space_to_depth_conv_equals_the_plain_conv(case):
    C, T, H, W, co, kernel, stride, padding = CASES[case]
    assert fits_space_to_depth((1, C, T, H, W), stride)
    _against_the_plain_conv(space_to_depth_conv3d, *CASES[case])


@pytest.mark.parametrize("case", list(TEMPORAL_CASES), ids=list(TEMPORAL_CASES))
def test_temporal_conv_as_2d_equals_the_plain_conv(case):
    C, T, H, W, co, kernel, stride, padding, cl = TEMPORAL_CASES[case]
    assert fits_temporal_2d(kernel, stride, padding)
    _against_the_plain_conv(temporal_conv3d_as_2d, *TEMPORAL_CASES[case])


def test_space_to_depth_takes_only_even_sizes_at_stride_2():
    assert fits_space_to_depth((8, 3, 32, 224, 224), (1, 2, 2))
    assert fits_space_to_depth((8, 3, 32, 224, 224), (2, 2, 2))
    assert not fits_space_to_depth((8, 3, 32, 223, 224), (1, 2, 2))
    assert not fits_space_to_depth((8, 3, 32, 224, 225), (1, 2, 2))
    assert not fits_space_to_depth((8, 3, 32, 224, 224), (1, 1, 1))
    assert not fits_space_to_depth((8, 3, 32, 224, 224), (1, 2, 1))


def test_temporal_2d_takes_only_kernels_over_time_alone():
    assert fits_temporal_2d((3, 1, 1), (1, 1, 1), (1, 0, 0))
    assert fits_temporal_2d((7, 1, 1), (4, 1, 1), (3, 0, 0))
    assert not fits_temporal_2d((1, 1, 1), (1, 1, 1), (0, 0, 0))
    assert not fits_temporal_2d((1, 3, 3), (1, 1, 1), (0, 1, 1))
    assert not fits_temporal_2d((3, 1, 1), (1, 2, 2), (1, 0, 0))
    assert not fits_temporal_2d((3, 1, 1), (1, 1, 1), (1, 1, 1))


# (C, features, kernel, stride, padding)
LAYERS = {"stem": (3, 8, (3, 7, 7), (1, 2, 2), (1, 3, 3)),
          "temporal": (16, 8, (3, 1, 1), (1, 1, 1), (1, 0, 0))}


@pytest.mark.parametrize("layer", list(LAYERS), ids=list(LAYERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv3dbn_keeps_the_plain_convolution_on_the_cpu(dtype, layer):
    C, co, kernel, stride, padding = LAYERS[layer]
    m = Conv3dBN(C, co, kernel, stride, padding).eval()
    m.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(1, C, 4, 16, 16, generator=torch.Generator().manual_seed(2)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    n0 = Conv3dBN.s2d_convs, Conv3dBN.temporal_2d_convs
    with torch.no_grad():
        y = m(x)
        w = m.conv.weight.to(dtype=dtype, memory_format=torch.channels_last_3d)
        inv = m.bn.weight * torch.rsqrt(m.bn.running_var + m.bn.eps)
        shift = m.bn.bias - m.bn.running_mean * inv
        ref = (F.conv3d(x, w, None, stride, padding) * inv.to(dtype).view(-1, 1, 1, 1)
               + shift.to(dtype).view(-1, 1, 1, 1))
    assert (Conv3dBN.s2d_convs, Conv3dBN.temporal_2d_convs) == n0
    assert tuple(m.conv.weight.shape) == (co, C) + kernel
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
