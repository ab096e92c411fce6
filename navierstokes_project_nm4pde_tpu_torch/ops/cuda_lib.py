"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles the sources for sm_90a (one process per source, all
started together) and links them into one shared library with a plain C
interface, loaded with ctypes; tensors pass as `data_ptr()` integers and
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

import torch

from navierstokes_project_nm4pde_tpu_torch.utils.profiling import setup_phase

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = tuple(
    _PKG / "csrc" / name
    for name in ("macro_kernels.cu", "ensemble_kernels.cu", "probe_kernels.cu", "coarse_kernels.cu")
)
BUILD_DIR = _PKG / "build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (each returns an int: a CUDA error code,
# or for ns_macro_max_channels*, ns_macro_build_band_* and
# ns_macro_matvec_{band_cols,panel_rows} a size).  Kernels A-D and the
# coarse solve have an entry point for each element type, suffixed _f32 and
# _f64.
_SIGNATURES = {
    **{f"ns_macro_matvec_{t}": [_P, _P, _P, _I, _I, _I, _I, _I, _P] for t in ("f32", "f64")},
    **{f"ns_macro_build_{t}": [_P, _P, _P, _I, _I, _I, _I, _I, _P] for t in ("f32", "f64")},
    **{f"ns_macro_build_band_{k}": [_I, _I, _I, _I] for k in ("rows", "cols")},
    **{f"ns_macro_matvec_{k}": [_I, _I, _I] for k in ("band_cols", "panel_rows")},
    "ns_macro_max_channels": [],
    "ns_macro_max_channels_f64": [],
    **{
        f"ns_slot_{k}_{t}": [_P, _P, _P, _P, _I, _I, _P] if k == "reduce"
        else [_P, _P, _P, ctypes.c_longlong, _I, _P]
        for k in ("reduce", "gather") for t in ("f32", "f64")
    },
    "ns_sgemm_tn_f32": [_P, _P, _P, _I, _I, _I, _P],
    "ns_column_gather_f32": [_P, _P, _P, _I, _I, _P],
    **{f"ns_coarse_solve_{t}": [_P, _P, _P, _P, _I, _I, _I, _P] for t in ("f32", "f64")},
}
# element type -> the suffix of its kernels' entry points
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def count_key(name: str, dtype: torch.dtype) -> str:
    """A kernel's key in its wrappers' launch counts: `name` for its
    float32 entry point, `name`_f64 for its float64 one."""
    return name if dtype == torch.float32 else f"{name}_{SUFFIX[dtype]}"

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


def _build(so: Path) -> str:
    """Compile every source to an object at once, then link them into `so`;
    returns nvcc's output.  Raises (and stops every nvcc) on a failure."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{src.stem}.{tag}.o") for src in _SOURCES]
    tmp = so.with_name(f"{so.name}.{tag}")
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(_SOURCES, objs)
    ]
    try:
        log = "\n".join(proc.communicate(timeout=900)[0] for proc in procs)
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        res = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, timeout=900,
        )
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return log


def load() -> ctypes.CDLL:
    """The kernel library (argument types set), compiled on first call
    (set-up phase `setup.cuda_lib`)."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with setup_phase("setup.cuda_lib"):
        digest = hashlib.sha1()
        for src in _SOURCES:
            digest.update(src.read_bytes())
        so = BUILD_DIR / f"libns_kernels_{digest.hexdigest()[:12]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            build_log = _build(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
