"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, and loaded with ctypes.
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a finished build is reused. Nothing here runs at
import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of fnft_tpu_torch "
                       "are compiled from csrc/ at first use")


def library_path() -> Path:
    """Path of the shared library for the current sources (may not exist)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libfnft_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this version is built already.

    The compiler's output (``-Xptxas -v``: registers, spills, shared
    memory per kernel) is kept in ``_build/build.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(f) for f in sorted(CSRC_DIR.glob("*.cu")))]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees a torn file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.fnft_fused_tree_levels.argtypes = [
                vp, vp, vp, i64, i32, i32, i32, i32, vp]
            lib.fnft_fused_tree_levels.restype = i32
            lib.fnft_repulsion_sum.argtypes = [
                vp, vp, vp, vp, i32, i32, i32, i32, vp]
            lib.fnft_repulsion_sum.restype = i32
            _lib = lib
    return _lib
