"""K2, the fused eval-time I3D bottleneck: wrapper, plain version and BN fold.

Replaces ``stdd_tpu/ops/bottleneck_pallas.py::fused_bottleneck``. One call
computes a whole stride-1 bottleneck with its BatchNorms folded into the
convolutions::

    y = relu(shortcut(x) + c(relu(b(relu(a(x))))))

with ``a`` a tk×1×1 convolution (zero padding in T), ``b`` a 1×3×3
convolution (zero padding in H and W), ``c`` a 1×1×1 convolution and the
shortcut the identity or a 1×1×1 projection. The CUDA source
(``csrc/fused_bottleneck.cu``) holds two kernels that keep the two
64-channel intermediates in shared memory: bf16 runs on the tensor cores
(``mma.sync``), float32 on the CUDA cores (scalar FMAs); its source note
gives the bound and the design. :func:`fused_bottleneck` is the only entry
point: a CPU tensor goes to :func:`fused_bottleneck_reference`, a CUDA
tensor to the kernel of its dtype (built with ``nvcc`` at first use) or the
call raises.

Layout: activations are NCTHW tensors in ``channels_last_3d`` memory order,
the port's activation layout (``models/i3d.py``), whose memory is
``[B, T, H, W, C]``. Weights keep the JAX kernel's layout: ``wa [tk, Cin,
Ci]``, ``wb [3, 3, Ci, Ci]`` (dy, dx, in, out), ``wc [Ci, Co]``, ``ws [Cin,
Co]``; biases are float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_cuda_library

# what the kernels take: the inner width is fixed, the input width is
# staged in chunks of 16 channels (scalar) or 64, masked per 8 (bf16), and
# the output width in chunks of 64
KERNEL_CI = 64
KERNEL_CIN_MULTIPLE = 16
KERNEL_CO_MULTIPLE = 64
# the C entry point of each kernel, by dtype: bf16 on the tensor cores,
# float32 on the CUDA cores; neither stands in for the other
KERNELS = {torch.bfloat16: "fused_bottleneck_bf16_launch",
           torch.float32: "fused_bottleneck_f32_launch"}


def fold_bn(w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval BatchNorm into a convolution whose output channels are the
    last axis of ``w``: ``conv(x, w') + b' == BN(conv(x, w))``, in float32,
    or float64 for a float64 ``w``
    (``stdd_tpu/ops/bottleneck_pallas.py::fold_bn``)."""
    dt = torch.promote_types(w.dtype, torch.float32)
    inv = scale.to(dt) * torch.rsqrt(var.to(dt) + eps)
    return w.to(dt) * inv, bias.to(dt) - mean.to(dt) * inv


def _conv_weight(w: torch.Tensor, kernel: Tuple[int, int, int]) -> torch.Tensor:
    """``[..., Cin, Cout]`` with the leading axes ``kernel`` → F.conv3d's
    ``[Cout, Cin, kt, kh, kw]``."""
    cin, cout = w.shape[-2:]
    return w.reshape(*kernel, cin, cout).permute(4, 3, 0, 1, 2)


def fused_bottleneck_reference(x: torch.Tensor, wa, ba, wb, bb, wc, bc, ws=None, bs=None,
                               *, tk: int) -> torch.Tensor:
    """Plain PyTorch version of K2, rounding where the TPU kernel rounds: x
    and the weights in the compute dtype (``x.dtype``), every product summed
    in float32, ``xa`` and ``xb`` rounded to the compute dtype after their
    bias and ReLU, and ``y = relu((yc + bc) + res)`` (``res`` = x in float32
    or ``x·ws + bs``) rounded once. Products of bf16 values are exact in
    float32, so computing in float32 over the rounded operands is the
    kernel's arithmetic up to the order of the sums. Returns
    ``channels_last_3d`` NCTHW in ``x.dtype``."""
    dt = x.dtype
    f32 = torch.float32

    def op(w):                                # the kernel's operand: rounded, then exact in f32
        return w.to(dt).to(f32)

    xf = x.to(f32)
    a = F.conv3d(xf, _conv_weight(op(wa), (tk, 1, 1)), padding=(tk // 2, 0, 0))
    xa = F.relu(a + ba.to(f32).view(-1, 1, 1, 1)).to(dt).to(f32)
    b = F.conv3d(xa, _conv_weight(op(wb), (1, 3, 3)), padding=(0, 1, 1))
    xb = F.relu(b + bb.to(f32).view(-1, 1, 1, 1)).to(dt).to(f32)
    yc = F.conv3d(xb, _conv_weight(op(wc), (1, 1, 1))) + bc.to(f32).view(-1, 1, 1, 1)
    if ws is not None:
        res = F.conv3d(xf, _conv_weight(op(ws), (1, 1, 1))) + bs.to(f32).view(-1, 1, 1, 1)
    else:
        res = xf
    y = F.relu(yc + res).to(dt)
    return y.contiguous(memory_format=torch.channels_last_3d)


def _kernel_lib() -> ctypes.CDLL:
    lib = load_cuda_library("fused_bottleneck", "fused_bottleneck.cu")
    for name in KERNELS.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Build and load K2 now (it is otherwise built at its first launch)."""
    _kernel_lib()


def fused_bottleneck(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor,
                     bb: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
                     ws: Optional[torch.Tensor] = None, bs: Optional[torch.Tensor] = None,
                     *, tk: int) -> torch.Tensor:
    """K2: ``x`` [B, Cin, T, H, W] bf16 or float32 (``channels_last_3d``
    memory on the card) and BN-folded weights (any float dtype; cast to
    ``x.dtype`` here, as the TPU wrapper does) → ``[B, Co, T, H, W]`` in
    ``x.dtype``, ``channels_last_3d``. ``ws``/``bs`` give the projection
    shortcut; without them ``Cin`` must equal ``Co``. ``tk`` is 1 or 3.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    their dtype (``KERNELS``) on the current stream
    (``fused_bottleneck.launches`` counts those launches, and
    ``fused_bottleneck.launches_by_kernel`` each kernel's). No other device,
    dtype, layout or width is taken."""
    if x.dim() != 5:
        raise ValueError(f"x must be [B, Cin, T, H, W]; got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32; got {x.dtype}")
    if tk not in (1, 3):
        raise ValueError(f"tk must be 1 or 3; got {tk}")
    B, Cin, T, H, W = x.shape
    Ci = wb.shape[-1]
    Co = wc.shape[-1]
    project = ws is not None
    if project != (bs is not None):
        raise ValueError("ws and bs come together")
    shapes = {"wa": (wa, (tk, Cin, Ci)), "ba": (ba, (Ci,)), "wb": (wb, (3, 3, Ci, Ci)),
              "bb": (bb, (Ci,)), "wc": (wc, (Ci, Co)), "bc": (bc, (Co,))}
    if project:
        shapes.update(ws=(ws, (Cin, Co)), bs=(bs, (Co,)))
    elif Cin != Co:
        raise ValueError(f"an identity shortcut needs Cin == Co; got {Cin} and {Co}")
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}; got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device} but x on {x.device}")
    dt = x.dtype
    wa, wb, wc = wa.to(dt), wb.to(dt), wc.to(dt)
    ba, bb, bc = ba.float(), bb.float(), bc.float()
    if project:
        ws, bs = ws.to(dt), bs.float()
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, wa, ba, wb, bb, wc, bc, ws, bs, tk=tk)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cpu or cuda, not {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("fused_bottleneck needs x in channels_last_3d memory order "
                         "(memory [B, T, H, W, C])")
    if x.data_ptr() % 16:
        raise ValueError("fused_bottleneck needs x 16-byte aligned")
    if Ci != KERNEL_CI or Cin % KERNEL_CIN_MULTIPLE or Co % KERNEL_CO_MULTIPLE:
        raise ValueError(f"the kernel takes Ci == {KERNEL_CI}, Cin a multiple of "
                         f"{KERNEL_CIN_MULTIPLE} and Co a multiple of {KERNEL_CO_MULTIPLE}; "
                         f"got Ci={Ci}, Cin={Cin}, Co={Co}")
    if B > 65535 or T > 65535 or B * T * H * W * max(Cin, Co) >= 2 ** 31:
        raise ValueError(f"fused_bottleneck input too large: B={B}, T={T}, H={H}, W={W}, "
                         f"Cin={Cin}, Co={Co}")
    out = torch.empty((B, Co, T, H, W), dtype=dt, device=x.device,
                      memory_format=torch.channels_last_3d)
    if out.numel() == 0:
        return out
    wa, wb, wc, ba, bb, bc = (t.contiguous() for t in (wa, wb, wc, ba, bb, bc))
    if project:
        ws, bs = ws.contiguous(), bs.contiguous()
    if dt == torch.bfloat16 and any(t.data_ptr() % 16 for t in (wa, wb, wc, ws)
                                    if t is not None):
        raise ValueError("fused_bottleneck in bf16 needs wa, wb, wc and ws 16-byte aligned")
    name = KERNELS[dt]
    launch = getattr(_kernel_lib(), name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(x.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                    wc.data_ptr(), bc.data_ptr(), ws.data_ptr() if project else None,
                    bs.data_ptr() if project else None, out.data_ptr(), B, T, H, W, Cin, Co,
                    tk, stream)
    if rc != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed ({name}): cudaError {rc}")
    fused_bottleneck.launches += 1
    fused_bottleneck.launches_by_kernel[name] += 1
    return out


fused_bottleneck.launches = 0
fused_bottleneck.launches_by_kernel = dict.fromkeys(KERNELS.values(), 0)
