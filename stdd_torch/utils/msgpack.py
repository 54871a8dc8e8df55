"""flax's msgpack checkpoint format, read and written without a msgpack package.

A checkpoint written by ``flax.serialization.to_bytes`` (what
``stdd_tpu/utils/checkpoint.py::save_checkpoint`` writes) is plain msgpack —
maps, arrays, str/bin 8/16/32, ints, floats, bool and nil — with flax's
extension types for array leaves:

- ext 1, an ndarray: the msgpack array ``(shape, dtype name, C-order
  bytes)``;
- ext 3, a numpy scalar: the same payload, read back as a 0-d value;
- ext 2, a Python complex: the msgpack pair ``(real, imag)``.

``bfloat16`` leaves (numpy has no such dtype) come back as
``torch.bfloat16`` tensors: the raw bytes read as uint16 and viewed as
bfloat16. Every other array comes back as a numpy array. Leaves of more than
2**30 bytes are split by flax into ``{"__msgpack_chunked_array__": True,
"shape": {...}, "chunks": {...}}`` dicts; :func:`msgpack_restore` joins them
and :func:`msgpack_serialize` writes them so.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30       # flax's chunking threshold, in bytes
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends early: want {n} bytes at offset {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):                            # bin 8/16/32
        return bytes(r.take(r.unpack((">B", ">H", ">I")[b - 0xC4])))
    if b in (0xC7, 0xC8, 0xC9):                            # ext 8/16/32
        n = r.unpack((">B", ">H", ">I")[b - 0xC7])
        return _ext(r.unpack(">b"), r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    if 0xCC <= b <= 0xD3:                                  # uint / int 8..64
        return r.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
    if 0xD4 <= b <= 0xD8:                                  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):                            # str 8/16/32
        return str(r.take(r.unpack((">B", ">H", ">I")[b - 0xD9])), "utf-8")
    if b in (0xDC, 0xDD):                                  # array 16/32
        return [_decode(r) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):                                  # map 16/32
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"msgpack: byte 0x{b:02x} at offset {r.pos - 1} starts no object")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _array_from(payload: memoryview):
    shape, dtype, buf = unpackb(bytes(payload))
    shape = tuple(shape)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _array_from(payload)
    if code == EXT_NPSCALAR:
        a = _array_from(payload)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(bytes(payload))
        return complex(re, im)
    raise ValueError(f"msgpack: unknown extension type {code}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (with flax's extension types)."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the object")
    return out


# -- writer -------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
    if fix >= 0 and n <= fix_max:
        out.append(fix | n)
    elif len(codes) == 3 and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[-2], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[-1], n)
    else:
        raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    else:
        _pack_len(out, n, -1, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
    out += payload


def _array_payload(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return packb([list(a.shape), "bfloat16", a.view(torch.int16).numpy().tobytes()])
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.hasobject or a.dtype.names is not None:
        raise ValueError(f"msgpack: cannot write dtype {a.dtype}")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _encode(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.generic):
        # before int and float: np.float64 subclasses float, and flax writes
        # every numpy scalar as one (msgpack's strict_types)
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out += struct.pack(">B", code) + struct.pack(fmt, obj)
                    break
            else:
                raise ValueError(f"msgpack: int {obj} does not fit 64 bits")
        else:
            for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out += struct.pack(">B", code) + struct.pack(fmt, obj)
                    break
            else:
                raise ValueError(f"msgpack: int {obj} does not fit 64 bits")
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), -1, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, Mapping):
        _pack_len(out, len(obj), 0x80, 15, (0xDE, 0xDF))
        for k, v in obj.items():
            _encode(out, k)
            _encode(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0xDC, 0xDD))
        for v in obj:
            _encode(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` (dicts, lists, tuples, str, bytes, ints, floats,
    bool, None, numpy arrays and scalars, torch tensors) as msgpack with
    flax's extension types. Nothing the port writes is complex, so ext 2 is
    read but not written."""
    out = bytearray()
    _encode(out, obj)
    return bytes(out)


# -- flax's tree level: chunked leaves ------------------------------------------

def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def _chunk(a) -> dict:
    flat = a.reshape(-1)
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): int(n) for i, n in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree):
    if isinstance(tree, Mapping):
        # keys sorted, as flax's copy of the tree (jax.tree_util) orders them
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize``: a tree of dicts with array
    leaves → bytes, dict keys sorted and leaves over 2**30 bytes written as
    chunked dicts, so the same tree gives flax's bytes."""
    return packb(_chunk_leaves(tree))


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore``: bytes → the tree of dicts,
    chunked leaves joined back into arrays."""
    return _unchunk_leaves(unpackb(data))
