#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's two paths once each:
  * the single run: the projection stepper on the DFG 3D duct at 965,265
    DoF under the benchmark's solver settings (bench.py's default
    RunConfig, float32), kernels A and B;
  * the ensemble: 64 Reynolds-sweep members of 46,928 DoF each under
    scripts/bench_ensemble.py's settings (float32), through
    `run_ensemble`, kernels C and D;
and runs the two TPU-era measurement probes (kernels E and F).  It builds
the hand-written CUDA kernels from `navierstokes_project_nm4pde_tpu_torch/csrc`,
holds each against its plain PyTorch version at the shapes its path gives
it, times it, its plain version and the one PyTorch call that computes
the same function (call time with CUDA events, device time with
torch.profiler), gives each its bound (the least time the card could take
for the same bytes and operations), times kernel B's two designs in
turns, and holds short runs of each path on the card against the same
runs on the CPU in float64 (plain versions) on a small duct.  It imports
nothing of jax or of the JAX package, and fails if either was imported.

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
# kernel name -> (source, TPU kernel it replaces, relative tolerance against
# the plain version, measured against max |plain|: f32 sums in another
# order, or 0 for the copies)
KERNELS = {
    "macro_matvec": ("macro_kernels.cu", "navierstokes_project_nm4pde_tpu/ops/macroblock.py:265", 1e-5),
    "macro_build": ("macro_kernels.cu", "scripts/prof_macro_build_kernel.py:127", 1e-5),
    "slot_reduce": ("ensemble_kernels.cu", "navierstokes_project_nm4pde_tpu/ops/onehot.py:342", 1e-5),
    "slot_gather": ("ensemble_kernels.cu", "navierstokes_project_nm4pde_tpu/ops/onehot.py:247", 0.0),
    "sgemm_probe": ("probe_kernels.cu", "scripts/prof_macro_build_kernel.py:74", 1e-5),
    "column_gather": ("probe_kernels.cu", "scripts/prof_pallas_gather.py:49", 0.0),
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
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): device-memory
# bytes a second, and float32 operations a second outside the tensor cores.
# A kernel's bound is the larger of its bytes (each input read once, each
# output written once) and its operations over these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Top-level modules the port and this script must never import.
FORBIDDEN_MODULES = ("jax", "jaxlib", "navierstokes_project_nm4pde_tpu")
# The ensemble path: scripts/bench_ensemble.py's mesh and member count
# (64 x 46,928 DoF), its warm-up and timed steps, and the members of the
# small-duct check against the CPU.
ENSEMBLE_MESH = dict(lc=0.08, nz=6)
ENSEMBLE_MEMBERS = 64
ENSEMBLE_WARMUP = 16
ENSEMBLE_TIMED = 40
ENSEMBLE_AGREE_MEMBERS = 4


def bench_config(dtype: str = "float32"):
    """The RunConfig that `python bench.py` builds with no environment
    (bench.py:128-231), at the given dtype."""
    from navierstokes_project_nm4pde_tpu_torch.config import (
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


def ensemble_config(dtype: str = "float32"):
    """The RunConfig of scripts/bench_ensemble.py:47-61 (its defaults:
    maxiter 25, 8 steps a chunk, frozen Schur), at the given dtype.
    precond.s_recycle keeps its default 0: the pressure runs plain CG."""
    from navierstokes_project_nm4pde_tpu_torch.config import (
        NumericsConfig,
        PrecondConfig,
        RunConfig,
        SolverConfig,
        TimeConfig,
    )

    return RunConfig(
        time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-6, restart=8, maxiter=25, tol_mode="b", guess_order=2),
        precond=PrecondConfig(
            kind="yosida", f_iters=0, s_iters=3, s_solver="mg2_cg", f_solver="gmres",
            freeze_conv_diag=True, mg2_form="additive",
        ),
        numerics=NumericsConfig(
            dtype=dtype, precise_dots=False, steps_per_chunk=8, reduce_plan="columns",
            matmul_precision="highest", schur_agg=24, proj_schur="frozen",
            coarse_solve="chol", schur_spmv="auto",
        ),
    )


def sweep_nus(problem, members: int):
    """The members' viscosities, Re = U D / nu over linspace(20, 300)
    (bench_ensemble.py:68-70)."""
    import numpy as np

    return abs(problem.mean_velocity(0.0) or 1.0) * problem.diameter / np.linspace(20.0, 300.0, members)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Call time: mean ms of fn() over `reps` back-to-back calls between two
    CUDA events, from an idle queue.  For a kernel of a few µs this is the
    host's enqueue time, not the kernel's."""
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


def _profiled_kernels(fn, calls: int) -> tuple[int, float]:
    """(device activities recorded, their summed µs) over `calls` calls of
    fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    return sum(e.count for e in dev), sum(e.self_device_time_total for e in dev)


def device_ms(fn, reps: int) -> float:
    """Device time: the summed duration of every device kernel that `reps`
    calls of fn() launch (all of them, for a plain version that launches
    several), under torch.profiler, over `reps`.  Host gaps between the
    launches are not in it.  A profile of one call gives the kernels a call
    launches; a run whose count is not `reps` times that lost activity
    records (seen once on the card: 2 of 10) and is taken again."""
    fn()
    for _ in range(3):
        per_call = _profiled_kernels(fn, 1)[0]
        n, total_us = _profiled_kernels(fn, reps)
        if per_call > 0 and n == per_call * reps and total_us > 0:
            return total_us / 1e3 / reps
        log(f"  device_ms: {n} device activities for {reps} calls of {per_call}; profiling again")
    fail(f"torch.profiler recorded {n} device activities for {reps} calls, not {per_call} each")


def kernel_times(fn, plain, lib, reps: int) -> dict:
    """Call and device times of a kernel, its plain version and the one
    PyTorch call that computes the same function, in turns."""
    return dict(
        ms=time_ms(fn, reps), plain_ms=time_ms(plain, reps), library_ms=time_ms(lib, reps),
        device_ms=device_ms(fn, reps), plain_device_ms=device_ms(plain, reps),
        lib_device_ms=device_ms(lib, reps),
    )


def bound(nbytes: float, ops: float) -> dict:
    """The least ms the card could take to move `nbytes` and do `ops` f32
    operations, and which of the two bounds it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
        bytes=nbytes, ops=ops,
    )


def fmt_times(t: dict, b: dict) -> str:
    return (f"call {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms; "
            f"device {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms, "
            f"library {t['lib_device_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes'] / 1e6:.1f} MB, {b['ops'] / 1e9:.3f} Gop): "
            f"{b['bound_ms'] / t['device_ms']:.1%} of bound on device")


def compare(name, out, ref) -> float:
    """Max abs error of a kernel's output against its plain version; fails
    above the kernel's tolerance (relative to max |plain|)."""
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    tol = KERNELS[name][2]
    log(f"  {name}: max abs err {err:.3e}, max rel err {rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        fail(f"{name} disagrees with its plain version: rel err {rel:.3e} > {tol:g}")
    return err


def check_kernels(solver, reps: int) -> dict:
    """Kernels A and B against their plain versions on the solver's own
    plan (main-path shapes), with seeded random inputs; returns per-kernel
    records (launch counts filled in later)."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    mp, dev = solver.macro, solver.device
    nloc = mp.lidx.shape[2]
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    F_e = torch.randn((mp.E, nloc, nloc), generator=gen, device=dev)
    log(f"kernel B macro_build: F_e {tuple(F_e.shape)}, lidx {tuple(mp.lidx.shape)} -> [{mp.B}, {mp.U}, {mp.U}]")
    FtT = mb.macro_build(F_e, mp.lidx, mp.B, mp.U)
    ref = mb.macro_build_plain(F_e, mp.lidx, mp.B, mp.U)
    err_b = compare("macro_build", FtT, ref)
    err_v1 = float((mb.macro_build_v1(F_e, mp.lidx, mp.B, mp.U) - ref).abs().max())
    log(f"  macro_build_v1 (the earlier one-CTA-a-block design): max abs err {err_v1:.3e}")
    if not err_v1 <= KERNELS["macro_build"][2] * float(ref.abs().max()):
        fail(f"macro_build_v1 disagrees with the plain version: {err_v1:.3e}")
    del ref
    # the library call: index_add_ into zeros, its flat index built once
    UU = mp.U * mp.U
    li = mp.lidx.to(torch.int64)
    flat = (torch.arange(mp.B, device=dev).view(-1, 1, 1, 1) * UU
            + li[:, :, None, :] * mp.U + li[:, :, :, None]).reshape(-1)[: mp.E * nloc * nloc]
    F_flat, lib_out = F_e.reshape(-1), torch.empty(mp.B * UU, device=dev)
    t = kernel_times(
        lambda: mb.macro_build(F_e, mp.lidx, mp.B, mp.U),
        lambda: mb.macro_build_plain(F_e, mp.lidx, mp.B, mp.U),
        lambda: lib_out.zero_().index_add_(0, flat, F_flat), reps,
    )
    b = bound((F_e.numel() + mp.lidx.numel() + FtT.numel()) * 4, F_e.numel())
    log(f"  macro_build: {fmt_times(t, b)}")
    # the two designs in turns: v1, new, new, v1
    turns = [
        (name, time_ms(f, reps), device_ms(f, reps))
        for name, f in (
            ("v1", lambda: mb.macro_build_v1(F_e, mp.lidx, mp.B, mp.U)),
            ("new", lambda: mb.macro_build(F_e, mp.lidx, mp.B, mp.U)),
            ("new", lambda: mb.macro_build(F_e, mp.lidx, mp.B, mp.U)),
            ("v1", lambda: mb.macro_build_v1(F_e, mp.lidx, mp.B, mp.U)),
        )
    ]
    log("  macro_build designs in turns (call ms, device ms): " + "; ".join(
        f"{n} {c:.4f} / {d:.4f} ({b['bound_ms'] / d:.1%} of bound)" for n, c, d in turns))
    v1 = [(c, d) for n, c, d in turns if n == "v1"]
    rec["macro_build"] = dict(
        err=err_b, **t, **b,
        v1_ms=sum(c for c, _ in v1) / 2, v1_device_ms=sum(d for _, d in v1) / 2,
    )
    del F_e, F_flat, flat, lib_out, li

    errs, times, bounds = [], {}, {}
    for C in (3, 6):
        x_b = torch.randn((mp.B, mp.U, C), generator=gen, device=dev)
        log(f"kernel A macro_matvec: FtT {tuple(FtT.shape)} x_b {tuple(x_b.shape)}")
        errs.append(compare(
            "macro_matvec", mb.macro_matvec(FtT, x_b), mb.macro_matvec_plain(FtT, x_b)
        ))
        t = times[C] = kernel_times(
            lambda: mb.macro_matvec(FtT, x_b), lambda: mb.macro_matvec_plain(FtT, x_b),
            lambda: torch.bmm(FtT.transpose(1, 2), x_b), reps,
        )
        b = bounds[C] = bound((FtT.numel() + 2 * x_b.numel()) * 4, 2.0 * FtT.numel() * C)
        gbs = FtT.numel() * 4 / t["device_ms"] / 1e6
        log(f"  macro_matvec C={C}: {fmt_times(t, b)} ({gbs:.1f} GB/s of values on device)")
    rec["macro_matvec"] = dict(err=max(errs), **times[3], **bounds[3])
    return rec


def check_slot_kernels(solver, reps: int) -> dict:
    """Kernels C and D against their plain versions on the ensemble
    solver's element plans, at the ensemble path's channel counts (B = 64:
    192 for u-wide passes, 384 for the rhs/r0 reduce, 576 for the stacked
    [hist | u0 | w] gather)."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    plans, dev = solver.op.onehot, solver.device
    gen = torch.Generator(device=dev).manual_seed(1)
    B = ENSEMBLE_MEMBERS
    rec = {}
    # index bytes each kernel reads: C the CSR order and row offsets, D the
    # flat slot index (all int64)
    idx_bytes = {
        "slot_reduce": (plans.reduce.perm.numel() + plans.reduce.offsets.numel()) * 8,
        "slot_gather": plans.gather.numel() * 8,
    }
    for name, fn, plain, lib, widths, rows in (
        ("slot_reduce", oh.onehot_reduce, oh.onehot_reduce_plain,
         lambda x: torch.zeros((plans.n_rows, x.shape[1]), device=dev).index_add_(0, plans.gather, x),
         (3 * B, 6 * B), plans.n_slots),
        ("slot_gather", oh.onehot_gather, oh.onehot_gather_plain,
         lambda x: x.index_select(0, plans.gather), (3 * B, 9 * B), plans.n_rows),
    ):
        errs, times, bounds = [], {}, {}
        for C in widths:
            x = torch.randn((rows, C), generator=gen, device=dev)
            log(f"kernel {name}: payload {tuple(x.shape)}, {plans.n_slots} slots -> {plans.n_rows} rows")
            errs.append(compare(name, fn(plans, x), plain(plans, x)))
            t = times[C] = kernel_times(
                lambda: fn(plans, x), lambda: plain(plans, x), lambda: lib(x), reps
            )
            # every slot row once, every node row once; C's sums are its operations
            b = bounds[C] = bound(
                (plans.n_slots + plans.n_rows) * C * 4 + idx_bytes[name],
                plans.n_slots * C if name == "slot_reduce" else 0,
            )
            gbs = (plans.n_slots + plans.n_rows) * C * 4 / t["device_ms"] / 1e6
            log(f"  {name} C={C}: {fmt_times(t, b)} ({gbs:.1f} GB/s on device)")
            del x
        rec[name] = dict(err=max(errs), **times[widths[0]], **bounds[widths[0]])
    return rec


def run_probes(reps: int) -> dict:
    """Probes E and F against their plain versions at the TPU scripts'
    shapes, then timed.  Returns per-probe records, with the launches of
    the timed probe runs."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import probes

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(2)
    N = probes.SGEMM_N
    a = torch.randn((N, N), generator=gen, device=dev)
    b = torch.randn((N, N), generator=gen, device=dev)
    log(f"probe sgemm_probe: A^T B at [{N}, {N}]^2 f32")
    err_e = compare("sgemm_probe", probes.sgemm_probe(a, b), probes.sgemm_probe_plain(a, b))
    cases = []
    for n, w in probes.GATHER_SHAPES:
        src = torch.randn((n, w), generator=gen, device=dev)
        ci = probes.column_index(
            torch.randint(0, n, (n, w), generator=gen, device=dev, dtype=torch.int32), n
        )
        log(f"probe column_gather: [{n}, {w}]")
        cases.append((src, ci, compare(
            "column_gather", probes.column_gather(src, ci), probes.column_gather_plain(src, ci)
        )))

    probes.reset_launch_counts()  # the probe runs: timed launches of each probe
    t_e = kernel_times(
        lambda: probes.sgemm_probe(a, b), lambda: probes.sgemm_probe_plain(a, b),
        lambda: torch.mm(a.T, b), reps,
    )
    t_g = [
        kernel_times(
            lambda: probes.column_gather(src, ci), lambda: probes.column_gather_plain(src, ci),
            lambda: torch.gather(src, 0, ci.idx64), reps,
        )
        for src, ci, _ in cases
    ]
    launches = dict(probes.launch_counts)
    flop = 2.0 * N ** 3
    b_e = bound(3 * N * N * 4, flop)
    log(f"  sgemm_probe: {fmt_times(t_e, b_e)} (plain and library: cuBLAS, TF32 off); on device "
        f"{flop / t_e['device_ms'] / 1e9:.2f} TFLOP/s f32 FMA, plain {flop / t_e['plain_device_ms'] / 1e9:.2f}")
    b_g = []
    for (src, ci, _), t in zip(cases, t_g):
        n_el, w = src.numel(), src.shape[1]
        # the source elements this index reads (each once), the index, the output
        used = torch.unique(ci.idx64 * w + torch.arange(w, device=dev)).numel()
        b_g.append(bound((used + 2 * n_el) * 4, 0))
        log(f"  column_gather {tuple(src.shape)}: {fmt_times(t, b_g[-1])}; on device "
            f"{t['device_ms'] / n_el * 1e6:.4f} ns/elem, plain {t['plain_device_ms'] / n_el * 1e6:.4f}")
    return {
        "sgemm_probe": dict(err=err_e, launches=launches["sgemm_probe"], **t_e, **b_e),
        "column_gather": dict(
            err=max(e for _, _, e in cases), launches=launches["column_gather"], **t_g[1], **b_g[1]
        ),
    }


def check_small_duct(device) -> None:
    """The port on the card (f32, kernels) against the port on the CPU
    (f64, plain versions) on a small duct."""
    import numpy as np

    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
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


def check_small_ensemble(device) -> None:
    """The port's ensemble on the card (f32, kernels C and D) against the
    same ensemble on the CPU (f64, plain versions) on a small duct, each
    member held to AGREE_RTOL of its own max |ref|."""
    import numpy as np

    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble

    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    problem = Cylinder3DProblem(test_case=2)
    nus = sweep_nus(problem, ENSEMBLE_AGREE_MEMBERS)
    (sg, dg), (sc, dc) = (
        run_ensemble(
            NavierStokesSolver(mesh, problem, ensemble_config(dtype), device=dev),
            nus, AGREE_STEPS,
        )
        for dev, dtype in ((device, "float32"), ("cpu", "float64"))
    )
    log(f"small-duct ensemble (B={len(nus)}, {sc.u.shape[0]} velocity nodes), {AGREE_STEPS} steps: "
        f"F iters card {dg.iters_f.tolist()} cpu {dc.iters_f.tolist()}, "
        f"S iters card {dg.iters_s.tolist()} cpu {dc.iters_s.tolist()}")
    worst = {}
    for m in range(len(nus)):
        ref = {k: getattr(sc, k)[..., m].numpy() for k in ("u", "p")}
        out = {k: getattr(sg, k)[..., m].double().cpu().numpy() for k in ("u", "p")}
        for k in ("c_d", "c_l", "delta_p"):
            ref[k], out[k] = getattr(dc, k)[m], getattr(dg, k)[m]
        for k in ref:
            scale = np.abs(ref["c_d" if k == "c_l" else k]).max()
            worst[k] = max(worst.get(k, 0.0), np.abs(out[k] - ref[k]).max() / scale)
    log("  max err vs cpu f64 over the members, relative to max |ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    for k, v in worst.items():
        if not v <= AGREE_RTOL:
            fail(f"small-duct ensemble: {k} err {v:.3e} > {AGREE_RTOL:g} of max |ref|")


def timed_steps(advance, state, n: int):
    """`n` steps, one `advance(state, 1)` call each (the path's run entry
    point), timed on the host clock up to a device synchronise; returns
    (state, diagnostics stacked along the step axis, ms per step)."""
    import dataclasses

    import numpy as np
    import torch

    step_ms, diags = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, dg = advance(state, 1)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        diags.append(dg)
    d = type(diags[0])(**{
        f.name: np.concatenate([getattr(x, f.name) for x in diags], axis=-1)
        for f in dataclasses.fields(diags[0])
    })
    return state, d, step_ms


def profile_steps(advance, state, n: int, out_dir: str, tag: str):
    """Trace `n` steps (`advance(state, n)`) with torch.profiler; write the
    kernel table and a chrome trace under out_dir, named by `tag`.
    Returns the device-busy ms per step."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, d = advance(state, n)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # one stream: the device is busy for the sum of its kernels' times
    busy = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"profile_{tag}_table.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{tag}_trace.json"))
    log(table)
    log(f"profiled {n} {tag} steps (F iters {d.iters_f.tolist()}, S iters {d.iters_s.tolist()}): "
        f"wall {wall:.3f} ms under the profiler, device busy {busy:.3f} ms "
        f"({busy / n:.3f} ms/step)")
    return busy / n


def check_run(path: str, solver, state, d, launches: dict) -> None:
    """Fail on a non-finite result, a timed step at maxiter (any member),
    or a kernel of the path that was never launched."""
    import numpy as np

    maxit = solver.config.solver.maxiter
    for k in ("c_d", "c_l", "delta_p", "residual"):
        if not np.all(np.isfinite(getattr(d, k))):
            fail(f"{path}: non-finite {k} in the timed steps")
    if not (np.all(np.isfinite(state.u.cpu().numpy())) and np.all(np.isfinite(state.p.cpu().numpy()))):
        fail(f"{path}: non-finite u or p after the timed steps")
    if np.any(d.iters_f >= maxit) or np.any(d.iters_s >= maxit):
        fail(f"{path}: a timed step reached maxiter={maxit}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{path}: the path never launched kernel {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace 3 single-run and 2 ensemble steps into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import numpy as np

    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.ops import cuda_lib
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh
    from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble

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
    mp = solver.macro  # built at first use: part of this path's setup
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
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
    state, d, step_ms = timed_steps(
        lambda st, k: solver.run(k, state=st), state, TIMED_STEPS
    )
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
    check_run("single run", solver, state, d, launches)

    if args.profile:
        busy = profile_steps(lambda st, k: solver.run(k, state=st), state, 3, args.profile, "single")
        log(f"device idle share, profiled device ms/step against the timed mean: "
            f"{1 - busy * n / sum(step_ms):.4f}")
    del solver, state

    # ---- 6. the ensemble: setup, kernels C and D, a small-duct check ------
    t0 = time.perf_counter()
    emesh = cylinder_duct_3d(**ENSEMBLE_MESH)
    eproblem = Cylinder3DProblem(test_case=2)
    esolver = NavierStokesSolver(emesh, eproblem, ensemble_config("float32"), device=device)
    plans = esolver.op.onehot  # built at first use: part of this path's setup
    torch.cuda.synchronize()
    e_setup = time.perf_counter() - t0
    B = ENSEMBLE_MEMBERS
    nus = sweep_nus(eproblem, B)
    log(f"ensemble setup: {emesh.n_cells} cells, {esolver.space.n_dofs} DoF a member "
        f"({esolver.space.n_unodes} velocity / {esolver.space.n_pnodes} pressure nodes), "
        f"B={B}: {B * esolver.space.n_dofs} DoF in all; {plans.n_slots} element slots, "
        f"max valence {int(plans.reduce.lengths.max())}; host setup {e_setup:.2f} s")
    rec.update(check_slot_kernels(esolver, KERNEL_REPS))
    check_small_ensemble(device)

    # ---- 7. the ensemble path ----------------------------------------------
    t0 = time.perf_counter()
    estate, ew = run_ensemble(esolver, nus, ENSEMBLE_WARMUP)
    torch.cuda.synchronize()
    log(f"ensemble warm-up: {ENSEMBLE_WARMUP} steps in {time.perf_counter() - t0:.2f} s; "
        f"F iters a step (max over members) {ew.iters_f.max(axis=0).tolist()}, "
        f"S {ew.iters_s.max(axis=0).tolist()}")
    torch.cuda.reset_peak_memory_stats(device)
    oh.reset_launch_counts()
    estate, ed, e_ms = timed_steps(
        lambda st, k: run_ensemble(esolver, nus, k, state=st), estate, ENSEMBLE_TIMED
    )
    launches.update(oh.launch_counts)
    ne, q = ENSEMBLE_TIMED, np.percentile(e_ms, [25, 50, 75])
    log(f"ensemble timed: {ne} steps of {B} members in {sum(e_ms) / 1e3:.4f} s: "
        f"{1e3 * B * ne / sum(e_ms):.4f} member-steps/s, {sum(e_ms) / ne:.4f} ms/step mean; "
        f"per step median {q[1]:.4f} ms, quartiles {q[0]:.4f} / {q[2]:.4f} ms, "
        f"max {max(e_ms):.4f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB; host setup {e_setup:.2f} s")
    log(f"  ms per step {[round(t, 3) for t in e_ms]}")
    for k in ("iters_f", "iters_s"):
        it = getattr(ed, k)
        log(f"  {k} per member and step: max {it.max()}, mean {it.mean():.3f}; "
            f"per step max {it.max(axis=0).tolist()}, mean {np.round(it.mean(axis=0), 2).tolist()}")
    log(f"  last step, Re 20 / 300: c_d {ed.c_d[0, -1]:.8g} / {ed.c_d[-1, -1]:.8g}, "
        f"c_l {ed.c_l[0, -1]:.8g} / {ed.c_l[-1, -1]:.8g}, "
        f"delta_p {ed.delta_p[0, -1]:.8g} / {ed.delta_p[-1, -1]:.8g}, t {estate.t:.6g}")
    log(f"  kernel launches in the timed run: {dict(oh.launch_counts)}")
    check_run("ensemble", esolver, estate, ed, dict(oh.launch_counts))

    if args.profile:
        busy = profile_steps(
            lambda st, k: run_ensemble(esolver, nus, k, state=st), estate, 2,
            args.profile, "ensemble",
        )
        log(f"ensemble device idle share, profiled device ms/step against the timed mean: "
            f"{1 - busy * ne / sum(e_ms):.4f}")
    del esolver, estate

    # ---- 8. the probes ------------------------------------------------------
    prec = run_probes(KERNEL_REPS)
    rec.update(prec)
    launches.update({k: v["launches"] for k, v in prec.items()})
    for name in prec:
        if launches[name] <= 0:
            fail(f"the probe run never launched kernel {name}")
    imported = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
    if imported:
        fail(f"imported modules of jax or of the JAX package: {imported[:10]}")

    kernels = []
    for name in KERNELS:
        r = rec[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{KERNELS[name][0]}",
            replaces=KERNELS[name][1],
            launches=launches[name], max_abs_err=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            device_ms=r["device_ms"], plain_device_ms=r["plain_device_ms"],
            lib_device_ms=r["lib_device_ms"], share=r["bound_ms"] / r["device_ms"],
            **{k: r[k] for k in ("v1_ms", "v1_device_ms") if k in r},
        ))
        log(f"{name}: device {r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({r['bound_ms'] / r['device_ms']:.1%}), library {r['lib_device_ms']:.4f} ms")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
