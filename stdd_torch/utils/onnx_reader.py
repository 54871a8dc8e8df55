"""Minimal ONNX reader: raw protobuf wire-format parser, no onnx/protobuf deps.

The port's own copy of ``stdd_tpu/utils/onnx_reader.py`` (the port imports
nothing of ``stdd_tpu``), unchanged but for this docstring. The reference
executes its detectors from ONNX via OpenCV's C++ DNN engine
(``preprocessing/yunet/yunet.py:47``); the port loads the same files and
runs them with :class:`stdd_torch.models.onnx_torch.OnnxModule`. Only the
message fields needed to rebuild a graph are decoded: nodes, initializers,
attributes, inputs/outputs. ``stdd_torch/utils/onnx_writer.py`` writes the
same subset.

Field numbers follow the onnx.proto3 schema (stable since ONNX IR v3):
  ModelProto:   7=graph
  GraphProto:   1=node 2=name 5=initializer 11=input 12=output 13=value_info
  NodeProto:    1=input 2=output 3=name 4=op_type 5=attribute(legacy)/7=attribute
  TensorProto:  1=dims 2=data_type 4=float_data 5=int32_data 7=int64_data
                8=name 9=raw_data
  AttributeProto: 1=name 2=f 3=i 4=s 5=t 6=g 7=floats 8=ints 9=strings 20=type
  ValueInfoProto: 1=name 2=type (TypeProto: 1=tensor_type; Tensor: 1=elem_type 2=shape)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ONNX TensorProto.DataType → numpy
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} at {pos}")
        yield fnum, wtype, val


@dataclass
class OnnxTensor:
    name: str
    array: np.ndarray


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclass
class OnnxGraph:
    name: str
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]
    outputs: List[str]
    input_shapes: Dict[str, Tuple[Optional[int], ...]] = field(default_factory=dict)


def _parse_tensor(buf: bytes) -> OnnxTensor:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = b""
    f32: List[float] = []
    i64: List[int] = []
    i32: List[int] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            if wtype == 2:  # packed repeated int64 dims (proto3 writers)
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
            else:
                dims.append(val)
        elif fnum == 2:
            dtype = val
        elif fnum == 4:
            if wtype == 2:  # packed floats
                f32.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                f32.append(struct.unpack("<f", val)[0])
        elif fnum == 5:
            if wtype == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    i32.append(v)
            else:
                i32.append(val)
        elif fnum == 7:
            if wtype == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    i64.append(v)
            else:
                i64.append(val)
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    np_dtype = _DTYPES[dtype]
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif f32:
        arr = np.asarray(f32, dtype=np.float32)
    elif i64:
        arr = np.asarray(i64, dtype=np.int64)
    elif i32:
        arr = np.asarray(i32, dtype=np.int32)
    else:
        arr = np.zeros(0, np_dtype)
    # reshape even when dims == [] so scalar tensors come out 0-d
    try:
        arr = arr.reshape(dims)
    except ValueError:
        pass
    return OnnxTensor(name, arr)


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    name = ""
    value: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            value = struct.unpack("<f", val)[0]
        elif fnum == 3:
            # zigzag not used by onnx (int64 field, plain varint, two's complement)
            value = val - (1 << 64) if val >= (1 << 63) else val
        elif fnum == 4:
            value = val.decode(errors="replace")
        elif fnum == 5:
            value = _parse_tensor(val).array
        elif fnum == 7:
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                ints.append(val - (1 << 64) if val >= (1 << 63) else val)
        elif fnum == 9:
            strings.append(val)
    if floats:
        value = floats
    elif ints:
        value = ints
    elif strings:
        value = [s.decode(errors="replace") for s in strings]
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attrs: Dict[str, Any] = {}
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            inputs.append(val.decode())
        elif fnum == 2:
            outputs.append(val.decode())
        elif fnum == 3:
            name = val.decode()
        elif fnum == 4:
            op_type = val.decode()
        elif fnum in (5, 7):
            k, v = _parse_attr(val)
            attrs[k] = v
    return OnnxNode(op_type, name, inputs, outputs, attrs)


def _parse_value_info(buf: bytes) -> Tuple[str, Tuple[Optional[int], ...]]:
    name = ""
    shape: List[Optional[int]] = []
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # Dimension
                                    dim: Optional[int] = None
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1:  # dim_value
                                            dim = v5
                                    shape.append(dim)
    return name, tuple(shape)


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        buf = f.read()
    graph_buf = None
    for fnum, _, val in _fields(buf):
        if fnum == 7:
            graph_buf = val
    if graph_buf is None:
        raise ValueError(f"{path}: no GraphProto found")

    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    inputs: List[str] = []
    outputs: List[str] = []
    input_shapes: Dict[str, Tuple[Optional[int], ...]] = {}
    gname = ""
    for fnum, _, val in _fields(graph_buf):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 2:
            gname = val.decode()
        elif fnum == 5:
            t = _parse_tensor(val)
            inits[t.name] = t.array
        elif fnum == 11:
            name, shape = _parse_value_info(val)
            inputs.append(name)
            input_shapes[name] = shape
        elif fnum == 12:
            name, _shape = _parse_value_info(val)
            outputs.append(name)
    # graph "inputs" include initializers in some exporters; filter them
    inputs = [i for i in inputs if i not in inits]
    return OnnxGraph(gname, nodes, inits, inputs, outputs, input_shapes)
