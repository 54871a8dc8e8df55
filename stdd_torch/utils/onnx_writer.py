"""ONNX writer for the subset ``onnx_reader`` decodes, and a YuNet-shaped graph.

``encode_onnx(graph)`` serialises an :class:`OnnxGraph` (nodes, attributes,
initializers, graph inputs and outputs) as ONNX ``ModelProto`` bytes with
the protobuf wire format written by hand, as ``onnx_reader`` reads it
without the onnx package. Both packages' readers parse these bytes, so a
graph built here crosses to the JAX package as a file, the way the real
YuNet ONNX would.

``yunet_shaped_graph(seed)`` builds a graph with YuNet's output contract
(``cls_/obj_/bbox_/kps_{8,16,32}``, each ``[1, HW/s², 1|1|4|10]``) and the
layout of libfacedetection.train's ``yunet_n`` config (``configs/yunet_n.py``:
``YuNetBackbone(stage_channels=[[3, 16, 16], [16, 64], [64, 64], [64, 64],
[64, 64], [64, 64]], downsample_idx=[0, 2, 3, 4], out_idx=[3, 4, 5])``,
``TFPN(in_channels=[64, 64, 64])``, ``YuNet_Head(in_channels=64,
feat_channels=64, shared_stacked_convs=0, stacked_convs=0)``): a stride-2
3→16 stem and a 16-channel depthwise-separable unit, 2×2 max-pools, five
64-channel stages of two depthwise-separable units, a top-down neck that
adds the nearest ×2 ``Resize`` of the coarser level, and per-stride heads
(1×1 conv then 3×3 depthwise, no activation) whose outputs are transposed
to NHWC, reshaped to ``[1, HW, C]``, with ``Sigmoid`` on cls and obj, as the
exported model ends. BatchNorm is folded into the convolutions, as an
export folds it. The weights are random from ``seed``; the head biases are
set so that tens of anchors clear YuNet's 0.6 score on the frames the tests
and ``chip_smoke.py`` feed it. Numpy only: it runs where neither JAX nor
the onnx package exists.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence

import numpy as np

from .onnx_reader import _DTYPES, OnnxGraph, OnnxNode

_CODES = {np.dtype(t): code for code, t in _DTYPES.items()}
_MASK64 = (1 << 64) - 1


def _varint(n: int) -> bytes:
    n &= _MASK64                       # int64 fields: two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _str(field: int, s: str) -> bytes:
    return _bytes(field, s.encode())


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _packed_varints(field: int, vals) -> bytes:
    return _bytes(field, b"".join(_varint(int(v)) for v in vals))


def encode_tensor(name: str, arr: np.ndarray, raw: bool = True) -> bytes:
    """TensorProto. ``raw`` writes ``raw_data`` and packed dims; otherwise
    float32 goes to ``float_data``, non-negative integers to ``int64_data``
    (the readers sign-correct neither typed field) and dims unpacked."""
    arr = np.asarray(arr)
    out = b""
    if raw:
        if arr.ndim:
            out += _packed_varints(1, arr.shape)
    else:
        out += b"".join(_int(1, d) for d in arr.shape)
    out += _int(2, _CODES[arr.dtype]) + _str(8, name)
    flat = np.ascontiguousarray(arr).reshape(-1)
    if not raw and arr.dtype == np.float32 and flat.size:
        out += _bytes(4, flat.astype("<f4").tobytes())
    elif not raw and arr.dtype.kind in "iu" and flat.size and flat.min() >= 0:
        out += _packed_varints(7, flat)
    elif flat.size:
        out += _bytes(9, flat.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def encode_attribute(name: str, value) -> bytes:
    """AttributeProto for a float, int, str, array (tensor) or a non-empty
    list of floats, ints or strs."""
    out = _str(1, name)
    if isinstance(value, (bool, int, np.integer)):
        return out + _int(3, value) + _int(20, 2)
    if isinstance(value, (float, np.floating)):
        return out + _key(2, 5) + struct.pack("<f", value) + _int(20, 1)
    if isinstance(value, str):
        return out + _str(4, value) + _int(20, 3)
    if isinstance(value, np.ndarray):
        return out + _bytes(5, encode_tensor("", value)) + _int(20, 4)
    value = list(value)
    if not value:
        raise ValueError(f"attribute {name!r}: an empty list has no type on the wire")
    if isinstance(value[0], str):
        return out + b"".join(_str(9, s) for s in value) + _int(20, 8)
    if isinstance(value[0], (float, np.floating)):
        return out + _bytes(7, struct.pack(f"<{len(value)}f", *value)) + _int(20, 6)
    return out + _packed_varints(8, value) + _int(20, 7)


def _value_info(name: str, shape) -> bytes:
    dims = b""
    for d in shape or ():
        dims += _bytes(1, _int(1, d) if d is not None else _str(2, "N"))
    tensor_type = _int(1, 1) + _bytes(2, dims)
    return _str(1, name) + _bytes(2, _bytes(1, tensor_type))


def encode_onnx(graph: OnnxGraph, raw: bool = True) -> bytes:
    """ModelProto bytes (IR 8, opset 13) of ``graph``."""
    g = b""
    for n in graph.nodes:
        body = b"".join(_str(1, i) for i in n.inputs) + b"".join(_str(2, o) for o in n.outputs)
        body += _str(3, n.name) + _str(4, n.op_type)
        body += b"".join(_bytes(5, encode_attribute(k, v)) for k, v in n.attrs.items())
        g += _bytes(1, body)
    g += _str(2, graph.name)
    g += b"".join(_bytes(5, encode_tensor(k, v, raw)) for k, v in graph.initializers.items())
    g += b"".join(_bytes(11, _value_info(i, graph.input_shapes.get(i))) for i in graph.inputs)
    g += b"".join(_bytes(12, _value_info(o, None)) for o in graph.outputs)
    opset = _str(1, "") + _int(2, 13)
    return _int(1, 8) + _str(2, "stdd_torch") + _bytes(8, opset) + _bytes(7, g)


def write_onnx(graph: OnnxGraph, path: str, raw: bool = True) -> str:
    with open(path, "wb") as f:
        f.write(encode_onnx(graph, raw))
    return path


# -- the YuNet-shaped graph -----------------------------------------------------

# yunet_n's stage widths after the stem (configs/yunet_n.py stage_channels)
YUNET_N_STAGES = ((16, 64), (64, 64), (64, 64), (64, 64), (64, 64))
YUNET_N_WIDTH = 64
# head biases: the cls/obj logit centre puts sqrt(cls·obj) above 0.6 for
# 34-65 of the 2100 anchors of a 320² scene frame (``eval/scene.py``, seeds
# 0-2) and 168 of a uniform-noise frame; bbox (dx, dy, log w, log h) gives
# boxes of about twice the stride; kps
HEAD_BIAS = {"cls": -0.5, "obj": -0.5, "bbox": (0.0, 0.0, 0.7, 0.7), "kps": 0.0}
HEAD_GAIN = {"cls": 1.0, "obj": 1.0, "bbox": 0.05, "kps": 0.05}


class _Builder:
    def __init__(self, rng: np.random.RandomState):
        self.rng = rng
        self.nodes: List[OnnxNode] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.n = 0

    def name(self, kind: str) -> str:
        self.n += 1
        return f"{kind}_{self.n}"

    def node(self, op: str, inputs: Sequence[str], **attrs) -> str:
        out = self.name(op.lower())
        self.nodes.append(OnnxNode(op, out, list(inputs), [out], attrs))
        return out

    def init(self, kind: str, arr: np.ndarray) -> str:
        name = self.name(kind)
        self.inits[name] = np.ascontiguousarray(arr)
        return name

    def conv(self, x: str, cin: int, cout: int, k: int, stride: int = 1, group: int = 1,
             gain: float = 1.0, bias=None) -> str:
        fan_in = (cin // group) * k * k
        w = self.rng.randn(cout, cin // group, k, k) * np.sqrt(2.0 / fan_in) * gain
        b = self.rng.randn(cout) * 0.05 if bias is None else np.broadcast_to(bias, (cout,))
        return self.node("Conv", [x, self.init("w", w.astype(np.float32)),
                                  self.init("b", np.asarray(b, np.float32))],
                         kernel_shape=[k, k], strides=[stride, stride],
                         pads=[k // 2] * 4, group=group)

    def dp_unit(self, x: str, cin: int, cout: int, relu: bool = True, gain: float = 1.0,
                bias=None) -> str:
        """ConvDPUnit: 1×1 conv, then 3×3 depthwise (BN folded), ReLU. The
        1×1 conv has no ReLU after it: half the He gain keeps the
        activations' scale from unit to unit."""
        y = self.conv(x, cin, cout, 1, gain=gain * np.sqrt(0.5))
        y = self.conv(y, cout, cout, 3, group=cout, gain=gain, bias=bias)
        return self.node("Relu", [y]) if relu else y

    def maxpool(self, x: str) -> str:
        return self.node("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])


def yunet_shaped_graph(seed: int = 0, input_hw=(320, 320)) -> OnnxGraph:
    """A random-weight graph with YuNet-n's layout and output contract; see
    the module docstring. ``input_hw`` only fills the input's declared
    shape: the graph runs at any size divisible by 32."""
    b = _Builder(np.random.RandomState(seed))
    # stem (ConvHead): 3→16 stride 2 on raw 0-255 BGR, then a DP unit
    x = b.conv("input", 3, 16, 3, stride=2, gain=1.0 / 128.0)
    x = b.node("Relu", [x])
    x = b.dp_unit(x, 16, 16)
    x = b.maxpool(x)                                             # stride 4
    feats = []
    for i, (cin, cout) in enumerate(YUNET_N_STAGES, start=1):    # Conv4layerBlock
        x = b.dp_unit(x, cin, cin)
        x = b.dp_unit(x, cin, cout)
        if i >= 3:
            feats.append(x)                                      # strides 8, 16, 32
        if i in (2, 3, 4):
            x = b.maxpool(x)
    # TFPN: top-down, nearest ×2 upsample of the coarser level added in
    scales = b.init("scales", np.array([1.0, 1.0, 2.0, 2.0], np.float32))
    for i in (1, 0):
        up = b.node("Resize", [feats[i + 1], "", scales], mode="nearest")
        feats[i] = b.dp_unit(b.node("Add", [feats[i], up]), YUNET_N_WIDTH, YUNET_N_WIDTH)
    outputs = []
    for s, f in zip((8, 16, 32), feats):
        for head, c in (("cls", 1), ("obj", 1), ("bbox", 4), ("kps", 10)):
            y = b.dp_unit(f, YUNET_N_WIDTH, c, relu=False, gain=HEAD_GAIN[head],
                          bias=HEAD_BIAS[head])
            y = b.node("Transpose", [y], perm=[0, 2, 3, 1])
            y = b.node("Reshape", [y, b.init("shape", np.array([1, -1, c], np.int64))])
            if head in ("cls", "obj"):
                y = b.node("Sigmoid", [y])
            name = f"{head}_{s}"
            b.nodes.append(OnnxNode("Identity", name, [y], [name], {}))
            outputs.append(name)
    return OnnxGraph("yunet_shaped", b.nodes, b.inits, ["input"], outputs,
                     {"input": (1, 3) + tuple(input_hw)})
