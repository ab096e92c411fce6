"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles the sources for sm_90a into a shared library with a plain
C interface, loaded with ctypes; tensors pass as `data_ptr()` integers and
kernels launch on PyTorch's current stream.  The library is built at first
use into `build/` beside this package (named by a hash of the sources, so
an edited kernel is rebuilt) and reused by later calls in the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "macro_kernels.cu",)
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_log = ""  # nvcc's output of this process's build (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    digest = hashlib.sha1()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libns_kernels_{digest.hexdigest()[:12]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ns_macro_matvec_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.ns_macro_matvec_f32.restype = i32
    lib.ns_macro_build_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.ns_macro_build_f32.restype = i32
    lib.ns_macro_max_channels.argtypes = []
    lib.ns_macro_max_channels.restype = i32
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
