"""First-use build of the hand-written CUDA kernels.

Each kernel source under ``stdd_torch/csrc/`` has a plain C interface; it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library in the
git-ignored ``stdd_torch/_build/`` directory and loaded with ``ctypes``.
The library name carries a hash of the source and flags, so an edited
source is rebuilt and a built one is reused. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "_build"
CSRC_DIR = PKG_DIR / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()                        # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}     # one per library: builds of two run in parallel
_libs: Dict[str, ctypes.CDLL] = {}
# by name: the library file, whether it was reused from an earlier build,
# and its ptxas report (registers, shared memory, spills), which is kept in
# a text file beside the library so a reused build still reports it
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def load_cuda_library(name: str, source: str) -> ctypes.CDLL:
    """Build (once per process and source) and load ``csrc/<source>``.
    Different libraries build concurrently when called from several
    threads; two calls for the same library wait for one build."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / source
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"{name}-{digest[:16]}.so"
        report = so.with_suffix(".ptxas.txt")
        reused = so.exists()
        if not reused:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
            report.write_text(res.stderr)
            os.replace(tmp, so)
        build_info[name] = dict(
            library=so.name, reused=reused,
            ptxas=report.read_text() if report.exists() else "")
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
