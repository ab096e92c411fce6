#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path once: the projection stepper on the DFG 3D
duct at 965,265 DoF under the benchmark's solver settings (bench.py's
default RunConfig, float32).  Before that it builds the hand-written CUDA
kernels from `navierstokes_project_nm4pde_tpu_torch/csrc`, holds each
against its plain PyTorch version at the shapes that path gives it, and
holds a short run of the port on the card against the same run on the CPU
in float64 (plain versions) on a small duct.

    python3 chip_smoke.py [--profile DIR]

Every phase that fails makes the exit code non-zero; without a CUDA device
the script exits 1 before printing any result.  The last three lines of
standard output are the kernels' JSON record, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PKG = "navierstokes_project_nm4pde_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/macro_kernels.cu"
# kernel name -> (TPU kernel it replaces, relative tolerance against the
# plain version: f32 sums in another order, measured against max |plain|)
KERNELS = {
    "macro_matvec": ("navierstokes_project_nm4pde_tpu/ops/macroblock.py:265", 1e-5),
    "macro_build": ("scripts/prof_macro_build_kernel.py:127", 1e-5),
}
# Small-duct check, float32 on the card against float64 on the CPU: the
# max error over the steps, relative to the max |reference| (for c_l, to
# max |c_d|: lift is a small difference of force integrals on drag's
# scale).  f32 rounding measured 5e-6 on u, 2e-6 on p and 1.6e-6 of
# max |c_d| on c_l through 5 steps (H100 80GB HBM3, 700 W).
AGREE_STEPS = 5
AGREE_RTOL = 1e-4
# The main path: steps from rest before the timed ones (iteration counts
# settle over the first ~15), the timed steps, and launches per kernel
# timing.
WARMUP_STEPS = 20
TIMED_STEPS = 40
KERNEL_REPS = 10


def bench_config(dtype: str = "float32"):
    """The RunConfig that `python bench.py` builds with no environment
    (bench.py:128-231), at the given dtype."""
    from navierstokes_project_nm4pde_tpu.config import (
        NumericsConfig,
        PrecondConfig,
        RunConfig,
        SolverConfig,
        TimeConfig,
    )

    return RunConfig(
        time=TimeConfig(
            dt=2e-4, t_end=4.0, stepper="projection", convection="implicit",
            imex_umax=9.0, imex_cfl=0.07,
        ),
        solver=SolverConfig(
            rtol=1e-6, restart=8, maxiter=60, tol_mode="b", guess_order=2,
            proj_div_cap=0.1,
        ),
        precond=PrecondConfig(
            kind="yosida", f_iters=0, f_corr_iters=0, s_iters=3,
            s_solver="mg2_cg", f_solver="gmres", low_precision=False,
            f_recycle=0, s_recycle=1, f_warmstart=0, freeze_conv_diag=True,
            mg2_form="additive",
        ),
        numerics=NumericsConfig(
            dtype=dtype, precise_dots=False, steps_per_chunk=80,
            reduce_plan="columns", matmul_precision="highest", schur_agg=24,
            element_contraction="vpu", proj_schur="frozen",
            coarse_solve="chol", schur_spmv="auto",
        ),
    )


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(solver, reps: int) -> dict:
    """Each kernel against its plain version on the solver's own plan
    (main-path shapes), with seeded random inputs; returns per-kernel
    records (launch counts filled in later)."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    mp, dev = solver.macro, solver.device
    nloc = mp.lidx.shape[2]
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    def compare(name, out, ref):
        err = float((out - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        tol = KERNELS[name][1]
        log(f"  {name}: max abs err {err:.3e}, max rel err {rel:.3e} (tol {tol:g})")
        if not rel <= tol:
            fail(f"{name} disagrees with its plain version: rel err {rel:.3e} > {tol:g}")
        return err

    F_e = torch.randn((mp.E, nloc, nloc), generator=gen, device=dev)
    log(f"kernel B macro_build: F_e {tuple(F_e.shape)}, lidx {tuple(mp.lidx.shape)} -> [{mp.B}, {mp.U}, {mp.U}]")
    FtT = mb.macro_build(F_e, mp.lidx, mp.B, mp.U)
    err_b = compare("macro_build", FtT, mb.macro_build_plain(F_e, mp.lidx, mp.B, mp.U))
    ms_b = time_ms(lambda: mb.macro_build(F_e, mp.lidx, mp.B, mp.U), reps)
    plain_b = time_ms(lambda: mb.macro_build_plain(F_e, mp.lidx, mp.B, mp.U), reps)
    log(f"  macro_build: {ms_b:.4f} ms, plain {plain_b:.4f} ms")
    rec["macro_build"] = dict(err=err_b, ms=ms_b, plain_ms=plain_b)
    del F_e

    errs, times = [], {}
    for C in (3, 6):
        x_b = torch.randn((mp.B, mp.U, C), generator=gen, device=dev)
        log(f"kernel A macro_matvec: FtT {tuple(FtT.shape)} x_b {tuple(x_b.shape)}")
        errs.append(compare(
            "macro_matvec", mb.macro_matvec(FtT, x_b), mb.macro_matvec_plain(FtT, x_b)
        ))
        times[C] = (
            time_ms(lambda: mb.macro_matvec(FtT, x_b), reps),
            time_ms(lambda: mb.macro_matvec_plain(FtT, x_b), reps),
        )
        gbs = FtT.numel() * 4 / times[C][0] / 1e6
        log(f"  macro_matvec C={C}: {times[C][0]:.4f} ms ({gbs:.1f} GB/s of values), plain {times[C][1]:.4f} ms")
    rec["macro_matvec"] = dict(err=max(errs), ms=times[3][0], plain_ms=times[3][1])
    return rec


def check_small_duct(device) -> None:
    """The port on the card (f32, kernels) against the port on the CPU
    (f64, plain versions) on a small duct."""
    import numpy as np

    from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder3DProblem,
        NavierStokesSolver,
    )

    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    (sg, dg), (sc, dc) = (
        NavierStokesSolver(
            mesh, Cylinder3DProblem(test_case=2), bench_config(dtype), device=dev
        ).run(AGREE_STEPS)
        for dev, dtype in ((device, "float32"), ("cpu", "float64"))
    )
    log(f"small duct ({sc.u.shape[0]} velocity nodes), {AGREE_STEPS} steps: "
        f"F iters card {dg.iters_f.tolist()} cpu {dc.iters_f.tolist()}, "
        f"S iters card {dg.iters_s.tolist()} cpu {dc.iters_s.tolist()}")
    ref = {k: getattr(sc, k).numpy() for k in ("u", "p")}
    out = {k: getattr(sg, k).double().cpu().numpy() for k in ("u", "p")}
    for k in ("c_d", "c_l", "delta_p"):
        ref[k], out[k] = getattr(dc, k), getattr(dg, k)
    errs = {
        k: np.abs(out[k] - ref[k]).max() / np.abs(ref["c_d" if k == "c_l" else k]).max()
        for k in ref
    }
    log("  max err vs cpu f64, relative to max |ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        if not v <= AGREE_RTOL:
            fail(f"small duct: {k} err {v:.3e} > {AGREE_RTOL:g} of max |ref|")


def timed_steps(solver, state, n: int):
    """`n` steps, one `run` call each, timed on the host clock up to a
    device synchronise; returns (state, stacked diagnostics, ms per step)."""
    import dataclasses

    import numpy as np
    import torch

    step_ms, diags = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, dg = solver.run(1, state=state)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        diags.append(dg)
    d = type(diags[0])(**{
        f.name: np.concatenate([getattr(x, f.name) for x in diags])
        for f in dataclasses.fields(diags[0])
    })
    return state, d, step_ms


def profile_steps(solver, state, n: int, out_dir: str):
    """Trace `n` steps with torch.profiler; write the kernel table and a
    chrome trace under out_dir.  Returns the device-busy ms per step."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, d = solver.run(n, state=state)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # one stream: the device is busy for the sum of its kernels' times
    busy = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(out_dir, "profile_table.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, "profile_trace.json"))
    log(table)
    log(f"profiled {n} steps (F iters {d.iters_f.tolist()}, S iters {d.iters_s.tolist()}): "
        f"wall {wall:.3f} ms under the profiler, device busy {busy:.3f} ms "
        f"({busy / n:.3f} ms/step)")
    return busy / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", help="also trace 3 steps into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import numpy as np

    from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.ops import cuda_lib
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    device = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); nvidia-smi: {smi_line}")

    # ---- 1. build the kernels --------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    if cuda_lib.build_log.strip():
        log(cuda_lib.build_log.strip())

    # ---- 2. the bench configuration's setup -------------------------------
    t0 = time.perf_counter()
    mesh = cylinder_duct_3d(lc=0.024, nz=14)
    t_mesh = time.perf_counter() - t0
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), bench_config("float32"), device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    mp = solver.macro
    log(f"setup: {mesh.n_cells} cells, {solver.space.n_dofs} DoF "
        f"({solver.space.n_unodes} velocity / {solver.space.n_pnodes} pressure nodes); "
        f"macro B={mp.B} U={mp.U} c_blk={mp.c_blk}; host setup {t_setup:.2f} s (mesh {t_mesh:.2f} s)")

    # ---- 3. kernels against their plain versions --------------------------
    rec = check_kernels(solver, KERNEL_REPS)

    # ---- 4. a short run against the CPU on a small duct -------------------
    check_small_duct(device)

    # ---- 5. the main path -------------------------------------------------
    t0 = time.perf_counter()
    state, dw = solver.run(WARMUP_STEPS)
    torch.cuda.synchronize()
    log(f"warm-up: {WARMUP_STEPS} steps in {time.perf_counter() - t0:.2f} s; "
        f"F iters {dw.iters_f.tolist()}, S iters {dw.iters_s.tolist()}")
    torch.cuda.reset_peak_memory_stats(device)
    mb.reset_launch_counts()
    state, d, step_ms = timed_steps(solver, state, TIMED_STEPS)
    launches = dict(mb.launch_counts)
    n, q = TIMED_STEPS, np.percentile(step_ms, [25, 50, 75])
    log(f"timed: {n} steps in {sum(step_ms) / 1e3:.4f} s: {1e3 * n / sum(step_ms):.4f} steps/s, "
        f"{sum(step_ms) / n:.4f} ms/step mean; per step median {q[1]:.4f} ms, "
        f"quartiles {q[0]:.4f} / {q[2]:.4f} ms, max {max(step_ms):.4f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    log(f"  ms per step {[round(t, 3) for t in step_ms]}")
    log(f"  F iters per step {d.iters_f.tolist()} (mean {d.iters_f.mean():.2f})")
    log(f"  S iters per step {d.iters_s.tolist()} (mean {d.iters_s.mean():.2f})")
    log(f"  last step: c_d {d.c_d[-1]:.8g}, c_l {d.c_l[-1]:.8g}, delta_p {d.delta_p[-1]:.8g}, t {state.t:.6g}")
    log(f"  kernel launches in the timed run: {launches}")

    maxit = solver.config.solver.maxiter
    for k in ("c_d", "c_l", "delta_p", "residual"):
        if not np.all(np.isfinite(getattr(d, k))):
            fail(f"non-finite {k} in the timed steps")
    if not (np.all(np.isfinite(state.u.cpu().numpy())) and np.all(np.isfinite(state.p.cpu().numpy()))):
        fail("non-finite u or p after the timed steps")
    if np.any(d.iters_f >= maxit) or np.any(d.iters_s >= maxit):
        fail(f"a timed step reached maxiter={maxit}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched kernel {name}")
    if any(m.split(".")[0] == "jax" for m in sys.modules):
        fail("jax was imported")

    if args.profile:
        busy = profile_steps(solver, state, 3, args.profile)
        log(f"device idle share, profiled device ms/step against the timed mean: "
            f"{1 - busy * n / sum(step_ms):.4f}")

    kernels = [
        dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=KERNELS[name][0],
            launches=launches[name], max_abs_err=rec[name]["err"],
            ms=rec[name]["ms"], plain_ms=rec[name]["plain_ms"],
        )
        for name in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
