"""ONNX → PyTorch executor: runs small inference graphs on the card.

Port of ``stdd_tpu/models/onnx_jax.py`` (``OnnxModule`` :25). The reference
runs its face detectors from ONNX via OpenCV's C++ DNN engine
(cv2.FaceDetectorYN in ``preprocessing/yunet/yunet.py:47``); here the same
files run as PyTorch ops: convolutions through ``F.conv2d`` (cuDNN on the
card), the rest eager. Each handler computes what its JAX counterpart
computes, including where that departs from the ONNX spec (Resize ignores
``coordinate_transformation_mode``; a ``linear`` downscale antialiases as
``jax.image.resize`` does). The graph is walked in file order (torch-jit
exports are topologically sorted).

Small integer initializers stay numpy on the host, as at
``onnx_jax.py:36-43``, and so do the values computed from them and from
``Shape``: a shape subgraph (Shape → Gather → Unsqueeze → Concat →
Reshape/Resize) folds on the host and no op waits for the device.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.onnx_reader import _DTYPES, OnnxGraph, OnnxNode, load_onnx

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                 np.dtype(np.float16): torch.float16, np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.bool_): torch.bool}


def _ceil_pads(shape_hw, k, s, pad_hw):
    """Pad the right/bottom edge up so the window count rounds up (ONNX
    ``ceil_mode``), as ``onnx_jax.py:129-136``."""
    pad_hw = list(pad_hw)
    for i, (dim, kk, ss) in enumerate(zip(shape_hw, k, s)):
        rem = (dim + pad_hw[i][0] + pad_hw[i][1] - kk) % ss
        if rem:
            pad_hw[i] = (pad_hw[i][0], pad_hw[i][1] + (ss - rem))
    return pad_hw


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``jax.image.resize(..., "linear")``
    along one axis (``jax/_src/image/scale.py::compute_weight_mat`` with
    the triangle kernel, antialias on, translation 0): half-pixel sample
    centres, the kernel widened by the downscale factor, weights normalised
    per output sample."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kernel_scale = max(inv, np.float32(1.0))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * float(inv) - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - (x / float(kernel_scale)).abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


class OnnxModule(torch.nn.Module):
    """``module(x)`` (single graph input) or ``module(**inputs)`` → dict of
    output tensors. Float initializers (and integer ones of more than 16
    elements) are buffers on ``device``; numpy inputs go to ``device`` too."""

    def __init__(self, graph: OnnxGraph, device="cuda"):
        super().__init__()
        self.graph = graph
        self.device = torch.device(device)
        self._np_inits = graph.initializers     # host copies for static shapes
        self._host: Dict[str, np.ndarray] = {}
        self._buffer_of: Dict[str, str] = {}
        for i, (k, v) in enumerate(graph.initializers.items()):
            if v.dtype.kind in "iu" and v.size <= 16:
                self._host[k] = v
                continue
            if v.dtype == np.float64:           # JAX runs with x64 off
                v = v.astype(np.float32)
            self._buffer_of[k] = f"init_{i}"
            self.register_buffer(f"init_{i}", torch.from_numpy(np.array(v)).to(self.device))

    @classmethod
    def from_file(cls, path: str, device="cuda") -> "OnnxModule":
        return cls(load_onnx(path), device=device)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.array(x)).to(self.device)   # a copy: readers' arrays are read-only

    def forward(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        env: Dict[str, Any] = dict(self._host)
        env.update({k: getattr(self, b) for k, b in self._buffer_of.items()})
        if args:
            if len(args) != len(self.graph.inputs):
                raise ValueError(f"expected {self.graph.inputs}, got {len(args)} args")
            kwargs = dict(zip(self.graph.inputs, args), **kwargs)
        env.update({k: self._tensor(v) for k, v in kwargs.items()})
        for node in self.graph.nodes:
            op = getattr(self, f"_op_{node.op_type.lower()}", None)
            if op is None:
                raise NotImplementedError(f"ONNX op {node.op_type}")
            outs = op(node, [env[i] if i else None for i in node.inputs])
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                env[name] = val
        return {o: env[o] for o in self.graph.outputs}

    def _binary(self, inputs, fn):
        a, b = inputs[0], inputs[1]
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            return fn(a, b)                     # host constant folding
        return fn(self._tensor(a), self._tensor(b))

    # -- ops (onnx_jax.py:71-335) ---------------------------------------------

    def _op_conv(self, node: OnnxNode, inputs):
        x, w = inputs[0], inputs[1]
        b = inputs[2] if len(inputs) > 2 else None
        strides = tuple(node.attrs.get("strides", [1, 1]))
        pads = node.attrs.get("pads", [0, 0, 0, 0])
        dil = tuple(node.attrs.get("dilations", [1, 1]))
        group = int(node.attrs.get("group", 1))
        if (pads[0], pads[1]) == (pads[2], pads[3]):
            padding = (pads[0], pads[1])
        else:                                   # asymmetric: zero-pad first
            x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
            padding = (0, 0)
        out = F.conv2d(x, w, None, strides, padding, dil, group)
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1)  # as JAX: bias added after the conv
        return out

    def _op_relu(self, node, inputs):
        return torch.clamp(inputs[0], min=0)

    def _op_leakyrelu(self, node, inputs):
        alpha = node.attrs.get("alpha", 0.01)
        x = inputs[0]
        return torch.where(x >= 0, x, alpha * x)

    def _op_sigmoid(self, node, inputs):
        return torch.sigmoid(inputs[0])

    def _op_softmax(self, node, inputs):
        return torch.softmax(inputs[0], dim=node.attrs.get("axis", -1))

    def _op_exp(self, node, inputs):
        return torch.exp(inputs[0])

    def _op_add(self, node, inputs):
        return self._binary(inputs, lambda a, b: a + b)

    def _op_sub(self, node, inputs):
        return self._binary(inputs, lambda a, b: a - b)

    def _op_mul(self, node, inputs):
        return self._binary(inputs, lambda a, b: a * b)

    def _op_div(self, node, inputs):
        return self._binary(inputs, lambda a, b: a / b)

    def _pool_pads(self, node, x):
        k = tuple(node.attrs.get("kernel_shape", [2, 2]))
        s = tuple(node.attrs.get("strides", k))
        pads = node.attrs.get("pads", [0, 0, 0, 0])
        pad_hw = [(pads[0], pads[2]), (pads[1], pads[3])]
        if int(node.attrs.get("ceil_mode", 0)):
            pad_hw = _ceil_pads(x.shape[2:], k, s, pad_hw)
        return k, s, pad_hw

    def _op_maxpool(self, node, inputs):
        x = inputs[0]
        k, s, ((t, bo), (l, r)) = self._pool_pads(node, x)
        x = F.pad(x, (l, r, t, bo), value=-float("inf"))
        return F.max_pool2d(x, k, s)

    def _op_averagepool(self, node, inputs):
        x = inputs[0]
        k, s, ((t, bo), (l, r)) = self._pool_pads(node, x)
        # window sums, then the divisor JAX uses: the window size, or with
        # the ONNX default count_include_pad=0 and any padding, the number
        # of non-pad elements (the same window sum over a ones image)
        out = F.avg_pool2d(F.pad(x, (l, r, t, bo)), k, s, divisor_override=1)
        if int(node.attrs.get("count_include_pad", 0)) or not any((t, bo, l, r)):
            return out / (k[0] * k[1])
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device),
                     (l, r, t, bo))
        return out / F.avg_pool2d(ones, k, s, divisor_override=1)

    def _op_globalaveragepool(self, node, inputs):
        return inputs[0].mean(dim=(2, 3), keepdim=True)

    def _op_transpose(self, node, inputs):
        x, perm = inputs[0], node.attrs["perm"]
        return np.transpose(x, perm) if isinstance(x, np.ndarray) else x.permute(*perm)

    def _op_reshape(self, node, inputs):
        x = inputs[0]
        shape_name = node.inputs[1]
        if shape_name in self._np_inits:
            shape = self._np_inits[shape_name]
        else:
            shape = inputs[1]
            if not isinstance(shape, np.ndarray):
                raise NotImplementedError("Reshape with a device shape input")
        shape = np.asarray(shape).astype(np.int64)
        # ONNX: 0 keeps the input dim, -1 infers
        shape = [int(x.shape[i]) if s == 0 else int(s) for i, s in enumerate(shape)]
        return x.reshape(shape)

    def _op_flatten(self, node, inputs):
        axis = node.attrs.get("axis", 1)
        x = inputs[0]
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return x.reshape(lead, -1)

    def _op_concat(self, node, inputs):
        axis = node.attrs.get("axis", 0)
        if all(isinstance(x, np.ndarray) for x in inputs):
            return np.concatenate(inputs, axis=axis)
        return torch.cat([self._tensor(x) for x in inputs], dim=axis)

    def _op_resize(self, node, inputs):
        x = inputs[0]
        mode = node.attrs.get("mode", "nearest")

        def resolve(i):
            if len(node.inputs) <= i or not node.inputs[i]:
                return None
            v = self._np_inits.get(node.inputs[i])
            if (v is None or np.size(v) == 0) and isinstance(inputs[i], np.ndarray):
                v = inputs[i]
            return None if v is None or np.size(v) == 0 else v

        scales = resolve(2)
        sizes = resolve(3)
        H, W = int(x.shape[2]), int(x.shape[3])
        if sizes is not None and len(sizes):
            out_hw = (int(sizes[2]), int(sizes[3]))
        else:
            out_hw = (int(round(H * float(scales[2]))), int(round(W * float(scales[3]))))
        if mode == "nearest":
            ry = out_hw[0] // H if out_hw[0] % H == 0 else 0
            rx = out_hw[1] // W if out_hw[1] % W == 0 else 0
            if ry and rx:
                return x.repeat_interleave(ry, dim=2).repeat_interleave(rx, dim=3)
            # jax.image.resize "nearest": source floor((i + 0.5) * in / out),
            # in float32, on each axis whose size changes
            for d, (n_in, n_out) in ((2, (H, out_hw[0])), (3, (W, out_hw[1]))):
                if n_in != n_out:
                    src = torch.floor((torch.arange(n_out, dtype=torch.float32, device=x.device)
                                       + 0.5) * n_in / n_out).long()
                    x = x.index_select(d, src)
            return x
        # jax.image.resize "linear": one weight matrix per axis whose size
        # changes, contracted in turn
        x = x.float() if not x.is_floating_point() else x
        if out_hw[0] != H:
            x = torch.einsum("nchw,hp->ncpw", x, _resize_weights(H, out_hw[0], x.device))
        if out_hw[1] != W:
            x = torch.einsum("nchw,wq->nchq", x, _resize_weights(W, out_hw[1], x.device))
        return x

    def _op_gemm(self, node, inputs):
        a, b = inputs[0], inputs[1]
        c = inputs[2] if len(inputs) > 2 else None
        alpha = node.attrs.get("alpha", 1.0)
        beta = node.attrs.get("beta", 1.0)
        if node.attrs.get("transA", 0):
            a = a.T
        if node.attrs.get("transB", 0):
            b = b.T
        out = alpha * (a @ b)
        if c is not None:
            out = out + beta * c
        return out

    def _op_matmul(self, node, inputs):
        return inputs[0] @ inputs[1]

    def _op_batchnormalization(self, node, inputs):
        x, scale, bias, mean, var = inputs[:5]
        eps = node.attrs.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + eps)
        return (x - mean.reshape(shape)) * (inv * scale).reshape(shape) + bias.reshape(shape)

    def _op_clip(self, node, inputs):
        lo = node.attrs.get("min")
        hi = node.attrs.get("max")
        if len(inputs) > 1 and inputs[1] is not None:
            lo = self._tensor(inputs[1])
        if len(inputs) > 2 and inputs[2] is not None:
            hi = self._tensor(inputs[2])
        if lo is None and hi is None:
            return inputs[0]
        if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
            # torch.clamp takes two numbers or two tensors, not one of each
            lo, hi = (v if v is None or isinstance(v, torch.Tensor) else self._tensor(
                np.float32(v)) for v in (lo, hi))
        return torch.clamp(inputs[0], min=lo, max=hi)

    def _op_identity(self, node, inputs):
        return inputs[0]

    def _op_shape(self, node, inputs):
        # static shapes → host constant (onnx_jax.py:280-283)
        return np.asarray(tuple(inputs[0].shape), np.int64)

    def _op_gather(self, node, inputs):
        axis = node.attrs.get("axis", 0)
        data, idx = inputs[0], inputs[1]
        if isinstance(data, np.ndarray):
            # np.take of a 0-d index returns a np scalar; keep it an ndarray
            return np.asarray(np.take(data, np.asarray(idx).astype(np.int64), axis=axis))
        axis %= data.dim()
        idx = self._tensor(idx).long()
        idx = torch.where(idx < 0, idx + data.shape[axis], idx)
        out = data.index_select(axis, idx.reshape(-1))
        return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape)
                           + tuple(data.shape[axis + 1:]))

    def _op_unsqueeze(self, node, inputs):
        axes = node.attrs.get("axes")
        if axes is None and len(node.inputs) > 1:
            axes = np.asarray(self._np_inits.get(node.inputs[1], inputs[1])).tolist()
        x = inputs[0]
        for a in sorted(axes):
            x = np.expand_dims(x, a) if isinstance(x, np.ndarray) else x.unsqueeze(a)
        return x

    def _op_squeeze(self, node, inputs):
        # axes as an attribute (opset < 13) or as an input (opset 13); the
        # JAX handler reads only the attribute and squeezes every unit axis
        # otherwise, which equals this whenever the named axes are the only
        # unit ones
        axes = node.attrs.get("axes")
        if axes is None and len(node.inputs) > 1 and node.inputs[1]:
            axes = np.asarray(self._np_inits.get(node.inputs[1], inputs[1])).tolist()
        x = inputs[0]
        if isinstance(x, np.ndarray):
            return x.squeeze() if axes is None else np.squeeze(x, tuple(axes))
        if axes is None:
            return x.squeeze()
        return x.squeeze(tuple(a % x.dim() for a in axes))

    def _op_cast(self, node, inputs):
        to = np.dtype(_DTYPES[int(node.attrs.get("to", 1))])
        x = inputs[0]
        return x.astype(to) if isinstance(x, np.ndarray) else x.to(_TORCH_DTYPES[to])

    def _op_slice(self, node, inputs):
        x = inputs[0]

        def const(i, default=None):
            if len(node.inputs) > i and node.inputs[i]:
                v = self._np_inits.get(node.inputs[i])
                if v is None and isinstance(inputs[i], np.ndarray):
                    v = inputs[i]
                if v is not None:
                    return np.asarray(v).tolist()
            return default

        starts = const(1)
        ends = const(2)
        axes = const(3, list(range(len(starts))))
        steps = const(4, [1] * len(starts))
        idx: List[Any] = [slice(None)] * x.ndim
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            idx[ax] = slice(st, None if en >= 2**31 - 1 else en, sp)
        if isinstance(x, np.ndarray):
            return x[tuple(idx)]
        for ax, sl in enumerate(idx):
            if sl.step is not None and sl.step < 0:    # torch slices step forward only
                pick = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
                x = x.index_select(ax, pick)
                idx[ax] = slice(None)
        return x[tuple(idx)]
