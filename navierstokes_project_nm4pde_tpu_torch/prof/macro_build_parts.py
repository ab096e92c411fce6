"""What bounds kernel B: time variants of it that run only some parts.

    python -m navierstokes_project_nm4pde_tpu_torch.prof.macro_build_parts

Needs one CUDA card and nvcc.  Builds `macro_build_parts.cu` into the
package's `build/`, makes the single run's macro plan (the DFG duct at
965,265 DoF: B = 10,864 blocks of 20 cells, U = 128) and seeded F_e, and
times, in two rounds, each variant of that file (CUDA events around 20
launches), the package's `macro_build`, and a memset
and a copy of the same 712 MB (the card's write and copy rates).  Every
variant that writes the full result is checked against the plain version.
It also lists the shared-memory atomic instructions the build compiled
to (`cuobjdump -sass`).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

from navierstokes_project_nm4pde_tpu_torch.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.ops import cuda_lib
from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

# Keep in step with kVariants in macro_build_parts.cu: (name, writes the
# full result).
VARIANTS = (
    ("committed: pairs over 1024 threads, 2 tiles, all parts", True),
    ("zero + store (the write-out alone)", False),
    ("zero + sum, pairs over 1024 threads", False),
    ("zero + sum, rows of 10 over 256 threads", False),
    ("rows of 10 over 256 threads, all parts", True),
    ("three tiles", True),
    ("no L2 evict_first hint on the store", True),
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM at 700 W (data sheet)
REPS = 20


def build() -> ctypes.CDLL:
    src = cuda_lib._PKG / "prof" / "macro_build_parts.cu"
    so = cuda_lib.BUILD_DIR / "libprof_macro_build_parts.so"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    sass = subprocess.run(
        [str(Path(cuda_lib._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True,
    ).stdout
    ops = sorted({
        ln.split("*/")[1].split()[0] for ln in sass.splitlines()
        if "ATOMS" in ln and "*/" in ln and ln.split("*/")[1].split()
    })
    print(f"shared-memory atomics in the SASS: {ops}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.prof_build_run.argtypes = [I, P, P, P, I, I, I, P]
    return lib


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("macro_build_parts: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    lib = build()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    space = build_taylor_hood(cylinder_duct_3d(lc=0.024, nz=14).reorder_spatial("rcm"))
    mp = mb.build_macro_plan(space.cells_u, space.n_unodes, U=128, c_blk=20, device=dev)
    print(f"plan: B={mp.B} E={mp.E} c_blk={mp.c_blk} in {time.perf_counter() - t0:.1f} s")
    F_e = torch.randn((mp.E, 10, 10), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    ref = mb.macro_build_plain(F_e, mp.lidx, mp.B, mp.U)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream
    nbytes = (F_e.numel() + mp.lidx.numel() + ref.numel()) * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"bound {bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB)")

    def variant(v):
        return lambda: lib.prof_build_run(
            v, F_e.data_ptr(), mp.lidx.data_ptr(), out.data_ptr(), mp.E, mp.B, mp.c_blk, stream
        )

    for rnd in range(2):
        for v, (name, full) in enumerate(VARIANTS):
            out.fill_(float("nan"))
            rc = variant(v)()
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"variant {v} failed to launch: CUDA error {rc}")
            err = float((out - ref).abs().max()) if full else None
            if full and not err <= 1e-5 * float(ref.abs().max()):
                raise SystemExit(f"variant {v} disagrees with the plain version: {err:.3e}")
            ms = event_ms(variant(v))
            print(f"round {rnd} variant {v} ({name}): {ms:.4f} ms, {bound / ms:.1%} of bound"
                  + (f", max abs err {err:.3e}" if full else ""))
        ms = event_ms(lambda: mb.macro_build(F_e, mp.lidx, mp.B, mp.U))
        print(f"round {rnd} package macro_build: {ms:.4f} ms, {bound / ms:.1%} of bound")
        for name, fn, moved in (
            ("memset (zero_) of the result's bytes", lambda: out.zero_(), ref.numel() * 4),
            ("copy_ of the result's bytes", lambda: out.copy_(ref), 2 * ref.numel() * 4),
        ):
            ms = event_ms(fn)
            print(f"round {rnd} {name}: {ms:.4f} ms, {moved / ms / 1e9:.3f} TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
