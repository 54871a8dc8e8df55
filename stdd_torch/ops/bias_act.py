"""K3, BatchNorm's shift with the residual and ReLU in one pass: wrapper and
plain version.

The port's counterpart of XLA's fusion of eval BatchNorm's affine, the
residual add and the ReLU in the JAX package (no TPU kernel computes them):
``models/i3d.py::Conv3dBN`` folds BN's scale into the convolution's weight,
and this pass adds BN's shift, the residual and the ReLU to the
convolution's output in place::

    y <- act(y + b[c] (+ r))

The CUDA kernel (``csrc/bias_act.cu``) takes 16-bit tensors with the
channels innermost; its source note gives the bound and the design.
:func:`bias_act` is the only entry point: a CPU tensor goes to
:func:`bias_act_reference`, a CUDA tensor to the kernel (built with ``nvcc``
at first use) or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import load_cuda_library

# the element types the kernel takes: the flag its entry point reads
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
# channels a 16-byte vector of the kernel covers
KERNEL_C_MULTIPLE = 8


def bias_act_reference(y: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None, relu: bool = False
                       ) -> torch.Tensor:
    """Plain PyTorch version of K3, in place: ``y`` [B, C, ...] ←
    ``act(y + bias[c] (+ residual))``, computed in float32 (float64 for a
    float64 ``y``) in that order and rounded to ``y``'s dtype once; returns
    ``y``."""
    dt = torch.promote_types(y.dtype, torch.float32)
    t = y.to(dt) + bias.to(dt).view((1, -1) + (1,) * (y.dim() - 2))
    if residual is not None:
        t = t + residual.to(dt)
    if relu:
        t = torch.relu(t)
    return y.copy_(t)


def _kernel_lib() -> ctypes.CDLL:
    lib = load_cuda_library("bias_act", "bias_act.cu")
    fn = lib.bias_act_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Build and load K3 now (it is otherwise built at its first launch)."""
    _kernel_lib()


def bias_act(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
             relu: bool = False) -> torch.Tensor:
    """K3, in place: ``y`` [B, C, ...] ← ``act(y + bias[c] (+ residual))``;
    returns ``y``.

    CPU tensors run the plain version. On the card ``y`` is a bf16 or fp16
    [B, C, T, H, W] tensor in ``channels_last_3d`` (dense, C innermost), C a
    multiple of 8, 16-byte aligned; ``bias`` float32 [C], contiguous;
    ``residual`` the same shape, dtype and layout as ``y``, not overlapping
    it. The kernel launches on the current stream (``bias_act.launches``
    counts those launches). Nothing else is taken."""
    if y.dim() < 2:
        raise ValueError(f"y must be [B, C, ...]; got shape {tuple(y.shape)}")
    C = y.shape[1]
    if bias.shape != (C,) or bias.device != y.device:
        raise ValueError(f"bias must be [{C}] on {y.device}; got {tuple(bias.shape)} on "
                         f"{bias.device}")
    if residual is not None and (residual.shape != y.shape or residual.dtype != y.dtype
                                 or residual.device != y.device):
        raise ValueError(f"residual must match y ({tuple(y.shape)}, {y.dtype}, {y.device}); got "
                         f"{tuple(residual.shape)}, {residual.dtype}, {residual.device}")
    if y.device.type == "cpu":
        return bias_act_reference(y, bias, residual, relu)
    if y.device.type != "cuda":
        raise ValueError(f"bias_act runs on cpu or cuda, not {y.device}")
    if y.dtype not in KERNEL_DTYPES or bias.dtype != torch.float32:
        raise ValueError(f"y must be bf16/fp16 and bias float32; got {y.dtype}, {bias.dtype}")
    if C % KERNEL_C_MULTIPLE:
        raise ValueError(f"bias_act needs C a multiple of {KERNEL_C_MULTIPLE}; got {C}")
    cl = torch.channels_last_3d
    if not (y.dim() == 5 and y.is_contiguous(memory_format=cl) and bias.is_contiguous()):
        raise ValueError("bias_act needs a [B, C, T, H, W] y in channels_last_3d and a "
                         "contiguous bias")
    ptrs = [y.data_ptr(), bias.data_ptr()]
    if residual is not None:
        if not residual.is_contiguous(memory_format=cl):
            raise ValueError("bias_act needs the residual in channels_last_3d, as y")
        lo, hi = residual.data_ptr(), residual.data_ptr() + residual.numel() * y.element_size()
        if lo < y.data_ptr() + y.numel() * y.element_size() and y.data_ptr() < hi:
            raise ValueError("residual overlaps y")
        ptrs.append(lo)
    if any(p % 16 for p in ptrs):
        raise ValueError("bias_act needs 16-byte aligned y, bias and residual")
    if y.numel() == 0:
        return y
    lib = _kernel_lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.bias_act_launch(
            y.data_ptr(), residual.data_ptr() if residual is not None else None,
            bias.data_ptr(), y.numel(), C, KERNEL_DTYPES[y.dtype], int(relu), stream)
    if rc != 0:
        raise RuntimeError(f"bias_act kernel launch failed: cudaError {rc}")
    bias_act.launches += 1
    return y


bias_act.launches = 0
