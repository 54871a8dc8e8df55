"""Native host-plane helpers (C++ via ctypes, numpy fallback).

Own copy of ``stdd_tpu/native``: the fused quality metric and the area
resize of the per-frame crop packing. ``quality.cpp`` is built with g++ at
first use into the git-ignored ``stdd_torch/_build/`` directory; without a
compiler every entry point reports "unavailable" and the callers take their
numpy twins. This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "quality.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_state = {"lib": None, "tried": False}


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = _BUILD_DIR / f"libstddnative-{digest}.so"
        try:
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.crop_lapvar_halfres.restype = ctypes.c_double
        lib.crop_lapvar_halfres.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ]
        lib.resize_area_pack.restype = None
        lib.resize_area_pack.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_double,
        ]
        _state["lib"] = lib
        return lib


def available() -> bool:
    return _load() is not None


def crop_lapvar_halfres(crop_rgb: np.ndarray) -> Optional[float]:
    """Fused half-res Laplacian variance; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(crop_rgb, dtype=np.uint8)
    h, w = c.shape[:2]
    return float(lib.crop_lapvar_halfres(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w))


def resize_area_pack(src_rgb: np.ndarray, dst_slot: np.ndarray, scale: float) -> bool:
    """Area-downscale ``src`` by ``scale`` into the (zeroed) square
    ``dst_slot`` in place. Returns False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    src = np.ascontiguousarray(src_rgb, dtype=np.uint8)
    if not (dst_slot.flags["C_CONTIGUOUS"] and dst_slot.dtype == np.uint8):
        raise ValueError("dst_slot must be a C-contiguous uint8 array")
    h, w = src.shape[:2]
    lib.resize_area_pack(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        dst_slot.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dst_slot.shape[0],
        ctypes.c_double(scale))
    return True
