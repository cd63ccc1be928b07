"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one process per
source, all started together, and linked into one shared library with a
plain C interface, at first use, and loaded with ctypes.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
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
            lib.fnft_repulsion_scratch_rows.argtypes = [
                i32, i32, ctypes.POINTER(i32)]
            lib.fnft_repulsion_scratch_rows.restype = i32
            lib.fnft_repulsion_sum.argtypes = [
                vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
            lib.fnft_repulsion_sum.restype = i32
            _lib = lib
    return _lib
