"""K1, the batched affine clip warp: wrapper, plain version and parameters.

Replaces ``stdd_tpu/ops/warp_pallas.py::warp_clip_pallas``. The CUDA kernel
(``csrc/warp_affine.cu``) is the exact bilinear gather for every affine; its
source note gives the bound and the design. :func:`warp_affine` is the only
entry point: a CPU tensor goes to :func:`warp_affine_reference`, a CUDA
tensor to the kernel (built with ``nvcc`` at first use) or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_cuda_library
from .align import bilinear_sample, invert_affine_2x3


def pack_warp_params(tfm: torch.Tensor, diffs: torch.Tensor) -> torch.Tensor:
    """Per-frame dst→src affine in crop-local coordinates, ``src = A⁻¹p − d_t``.

    ``tfm`` [..., 2, 3] forward cv2-convention affine (canvas → out),
    ``diffs`` [..., T, 2] crop offsets inside the canvas → ``[..., T, 8]``
    float32 (m00 m01 m02 m10 m11 m12, pad, pad), as
    ``stdd_tpu/ops/warp_pallas.py::pack_warp_params``."""
    Minv = invert_affine_2x3(tfm.float())
    T = diffs.shape[-2]
    base = torch.cat([Minv[..., 0, :], Minv[..., 1, :]], -1)           # [..., 6]
    params = base[..., None, :].expand(base.shape[:-1] + (T, 6)).clone()
    params[..., 2] += -diffs[..., 0].float()
    params[..., 5] += -diffs[..., 1].float()
    return torch.cat([params, params.new_zeros(params.shape[:-1] + (2,))], -1)


def warp_affine_reference(crops: torch.Tensor, params: torch.Tensor, out_size: int) -> torch.Tensor:
    """Plain PyTorch version of K1: ``crops`` [N, H, W, 3] uint8/float32,
    ``params`` [N, 8] float32 → [N, S, S, 3] float32. Output pixel (r, c)
    samples the crop at ``x = m00·c + m01·r + m02``, ``y = m10·c + m11·r + m12``."""
    S = out_size
    dev = crops.device
    p = params.float()
    rows = torch.arange(S, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(S, dtype=torch.float32, device=dev)[None, None, :]

    def m(i):
        return p[:, i, None, None]

    x = m(0) * cols + m(1) * rows + m(2)
    y = m(3) * cols + m(4) * rows + m(5)
    return bilinear_sample(crops, x, y)


def _kernel_lib() -> ctypes.CDLL:
    lib = load_cuda_library("warp_affine", "warp_affine.cu")
    fn = lib.warp_affine_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Build and load K1 now (it is otherwise built at its first launch)."""
    _kernel_lib()


def warp_affine(crops: torch.Tensor, params: torch.Tensor, out_size: int) -> torch.Tensor:
    """K1: ``crops`` [N, H, W, 3] uint8 or float32 (contiguous), ``params``
    [N, 8] float32 on the same device → ``[N, S, S, 3]`` float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (``warp_affine.launches`` counts those launches). No
    other device, dtype or layout is taken."""
    if crops.device != params.device:
        raise ValueError(f"crops on {crops.device} but params on {params.device}")
    if crops.dim() != 4 or crops.shape[-1] != 3:
        raise ValueError(f"crops must be [N, H, W, 3]; got {tuple(crops.shape)}")
    N, H, W, _ = crops.shape
    if params.shape != (N, 8):
        raise ValueError(f"params must be [{N}, 8]; got {tuple(params.shape)}")
    if crops.dtype not in (torch.uint8, torch.float32) or params.dtype != torch.float32:
        raise ValueError(f"crops must be uint8/float32 and params float32; got "
                         f"{crops.dtype}, {params.dtype}")
    if crops.device.type == "cpu":
        return warp_affine_reference(crops, params, out_size)
    if crops.device.type != "cuda":
        raise ValueError(f"warp_affine runs on cpu or cuda, not {crops.device}")
    if not (crops.is_contiguous() and params.is_contiguous()):
        raise ValueError("warp_affine needs contiguous crops and params")
    if N > 65535 or N * H * W * 3 >= 2 ** 31 or N * out_size * out_size * 3 >= 2 ** 31:
        raise ValueError(f"warp_affine batch too large: N={N}, H={H}, W={W}, S={out_size}")
    out = torch.empty((N, out_size, out_size, 3), dtype=torch.float32, device=crops.device)
    if N == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(crops.device):
        stream = torch.cuda.current_stream(crops.device).cuda_stream
        rc = lib.warp_affine_launch(
            crops.data_ptr(), int(crops.dtype == torch.uint8), params.data_ptr(),
            out.data_ptr(), N, H, W, out_size, stream)
    if rc != 0:
        raise RuntimeError(f"warp_affine kernel launch failed: cudaError {rc}")
    warp_affine.launches += 1
    return out


warp_affine.launches = 0
