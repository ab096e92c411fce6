#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's paths once each:
  * the single run: the projection stepper on the DFG 3D duct at 965,265
    DoF under the benchmark's solver settings (bench.py's default
    RunConfig, float32), kernels A and B;
  * the stepper's variants: IMEX convection at 965,265 DoF (bench.py with
    NS_BENCH_CONV=imex: the assembled constant K plus the fine cells'
    element pass, kernels C and D), explicit convection on the 46,928-DoF
    duct where it is stable, and the velocity accelerators at 965,265 DoF
    on the macro path (f_warmstart with the K/C split and the inverse
    coarse solve; f_recycle with the V(1,1) two-level form; kernel A at
    up to 15 channels);
  * the ensemble: 64 Reynolds-sweep members of 46,928 DoF each under
    scripts/bench_ensemble.py's settings (float32), through
    `run_ensemble`, kernels C and D;
  * the monolithic saddle-point stepper: the `cylinder3d` entry point at
    its defaults through the CLI's `main` (142,692 DoF, yosida, float32,
    the CSV files and final.npz checked), and at 965,265 DoF under
    bench.py's monolithic settings; every element pass through kernels C
    and D; host syncs a step counted by torch's sync debug mode;
  * the `cylinder2d` entry point at its defaults through the CLI (5,372
    DoF, monolithic, asimple; kernels C and D at 1 and 2 channels) and
    `--fast` on the 118,071-DoF channel under bdf1 and bdf2 (kernels A at
    2 channels and B at 6 local nodes); the `convergence` entry point at
    its defaults (the Ethier-Steinman ladder 2 4 8 16, up to 112,724 DoF;
    the last pair's rates and the errors against the CPU float64 run);
  * the `ensemble` entry point at its defaults through the CLI (the
    monolithic stepper, asimple, 64 members of 32,536 DoF; kernels C and D
    at 192 and 64 channels), and the ensemble's variants (both steppers,
    BDF2, explicit and IMEX convection, the recycle pools, the Schur
    variants) on a small duct against the CPU;
  * multi-device runs as two local ranks on the card (torch.distributed,
    gloo): `cylinder3d --shard-cells 2` at its defaults against the
    unsharded run, the owned+halo projection step at 142,692 DoF against
    the single-device step, and `ensemble --shard-batch`; each rank's
    imports and kernel launches are checked;
  * float64 on the card: the single run at 965,265 DoF under
    bench_config("float64") (kernels A and B in float64), the
    `cylinder3d` and `convergence` entry points at `--dtype float64`
    (kernels C and D in float64; convergence's errors against the CPU
    float64 run's to 1e-8), the small duct's bench, monolithic and B = 4
    ensemble runs against the CPU float64 runs (the same counts, u and p
    to 1e-9), and a CPU float64 state continued on the card through a
    checkpoint;
  * numerics.fold_elem=False and spatial_reorder=False on the small duct
    against the CPU, and the 64-member ensemble with fold_elem=False
    (member-steps/s, and a peak below the folded ensemble's);
  * wide macro blocks (numerics.macro_u = 192 at c_blk 34 and 256 at c_blk
    48, the widths the JAX package's profile measured): the single run at
    965,265 DoF at both in float32 and float64 (kernel B in bands of rows,
    its F and S counts beside the U = 128 run's), kernels A and B on the
    965k plan at U = 384 as well (kernel A in bands of columns), the small
    duct against the CPU (with the macro options forced on and
    f_warmstart=5) and cylinder2d --fast at U = 256; and kernels A and B
    at very wide blocks (U = 2,336-29,184: A's input panel in chunks of
    rows, B's tiles in bands of rows and columns);
  * the DFG validation runs (validation/dfg_validate.py, DFG 2D-2 with
    its kicked inlet, and validation/dfg3d_validate.py, DFG 3D-1Z): each on
    a small mesh against the CPU and through its `main`, then at scale
    (2D-2 at 53,049 DoF, 10 + 200 steps; 3D-1Z at 176,184 DoF, 5 + 50),
    kernels A, B and C checked on each run's plans;
    `--only dfg_full` runs VALIDATION.md's full-length runs (Re 100 and
    200, 18,000 steps each, and the 3D-1Z ladder) and holds each quantity
    to its limit, `--only dfg_spread` the small 2D-2 check's spread on the
    card, `--only dfg_drift` the 3D-1Z drift runs and `--only
    dfg_3d_spread` the 3D-1Z ladder's spread and its run with kernel B
    rounded to TF32 (none of the four is part of the default run);
and runs the two TPU-era measurement probes (kernels E and F).  It builds
the hand-written CUDA kernels from `navierstokes_project_nm4pde_tpu_torch/csrc`,
holds each against its plain PyTorch version at the shapes its paths give
it, times it, its plain version and the one PyTorch call that computes
the same function (call time with CUDA events from an idle queue, device
time with CUDA events behind a queued spin kernel), gives each its bound
(the least time the card could take for the same bytes and operations; a
device time below the bound by more than 5% fails the run), does the same
for kernels A-D in float64 (each kernel's "f64" record), times the
earlier and the committed designs of kernels A, B, C and D in turns, and
the K/C split's block build against the full one, and holds short runs
of each path and of each variant on the card against the same runs on
the CPU in float64 (plain versions) on a small duct (the monolithic
stepper's kinds and inner solvers, and the 2D channel, BDF2 and
Ethier-Steinman cases, to tolerances measured from the JAX package's own
float32 spread, and one preconditioner application of each to 100
float32 epsilons).  It imports nothing
of jax or of the JAX package, and fails if either was imported, in its
own process or in any rank it launched.  On an
H100 80GB HBM3 at 700 W the whole script, the kernels' build included,
took 184-243.5 s, 222.0-361.3 s with the 2D, BDF2 and convergence
phases, and 225.6 s with the ensemble entry point and multi-device
phases.

    python3 chip_smoke.py [--profile DIR]   # DIR: torch.profiler tables and traces
    python3 chip_smoke.py --only ensemble-variants ensemble-cli multi-device
    python3 chip_smoke.py --only float64-small unfolded-small
    python3 chip_smoke.py --only wide-macro
    python3 chip_smoke.py --only fault7 dfg
    python3 chip_smoke.py --only dfg_full --out-dir DIR   # or dfg_re100, dfg_re200, dfg_3d1z
    python3 chip_smoke.py --only dfg_spread dfg_drift dfg_3d_spread
    python3 chip_smoke.py --only coarse   # the frozen coarse solve at the duct's and the sweep's sizes
    python3 chip_smoke.py --only member-product   # kernel G at the sweep's plan, then on its path

Every phase that fails makes the exit code non-zero; without a CUDA device
the script exits 1 before printing any result.  The last three lines of
standard output are the kernels' JSON record, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
import warnings

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
# timing.  The IMEX and explicit runs take the same counts; the two
# velocity-accelerator runs at 965k take 10 + 20.
WARMUP_STEPS = 20
TIMED_STEPS = 40
ACCEL_WARMUP = 10
ACCEL_TIMED = 20
KERNEL_REPS = 10
# Kernel A's channel counts: the single run's 3 (Krylov applies), and the
# accelerators' wide payloads: f_warmstart = 2 (9), f_recycle = 4 (15),
# f_recycle = 7 (24), and past one launch's 24 channels (split into
# launches of at most 24, each reading FtT once): f_recycle = 8 (27, here
# 25) and f_recycle = 15 (48).
MATVEC_WIDTHS = (3, 9, 15, 24, 25, 48)
# Kernel A in float64: the float64 single run's 3 (its Krylov applies and
# rhs pass), its widest payload a launch (12), and past it (two launches).
F64_MATVEC_WIDTHS = (3, 12, 13)
# Kernels C and D at the variant paths' shapes: name -> (kernel -> channel
# counts).  IMEX at 965k runs the fine subset's plan at 3 channels every
# Krylov apply, and the full plan once a step (the rhs reduce at 6, the
# stacked [hist | u0 | w] gather at 9); explicit at 47k the full plan
# (N(u) and the rhs reduce at 3 and 6, the gather at 9).
SLOT_SHAPES = {
    # the ensemble's 64 members: every element pass at 3 B = 192 channels,
    # the rhs reduce at 6 B, the stacked gather at 9 B
    "ensemble": {"slot_reduce": (192, 384), "slot_gather": (192, 576)},
    "imex fine": {"slot_reduce": (3,), "slot_gather": (3,)},
    "imex full": {"slot_reduce": (6,), "slot_gather": (9,)},
    "explicit full": {"slot_reduce": (3, 6), "slot_gather": (9,)},
    # the monolithic stepper: every element pass (F, D, G, M) at 3 channels,
    # and diag C(w) (`convection_setup`, once a step) reduced at 1
    "monolithic 142k": {"slot_reduce": (1, 3), "slot_gather": (3,)},
    "monolithic 965k": {"slot_reduce": (1, 3), "slot_gather": (3,)},
    # the cylinder2d CLI's defaults (monolithic, triangles of 6 nodes): 2
    # channels, diag C(w) at 1; the convergence CLI's top level (cube_mesh(16))
    "cylinder2d defaults": {"slot_reduce": (1, 2), "slot_gather": (2,)},
    "convergence n=16": {"slot_reduce": (1, 3), "slot_gather": (3,)},
    # the ensemble CLI's defaults (monolithic, 64 members): every element
    # pass at 3 B = 192 channels, diag C(w) at B = 64
    "ensemble CLI defaults": {"slot_reduce": (192, 64), "slot_gather": (192,)},
    # kernels C and D in float64 at the ensemble's 3 B = 192 channels, on its
    # 64-member plan: the wide kernels' check; no float64 path runs this width
    "ensemble plan, 192 (float64 off-path)": {"slot_reduce": (192,), "slot_gather": (192,)},
    # a cell-sharded rank's block of the 142,692-DoF duct (the monolithic
    # passes, before the all-reduce), and the halo step's rank-0 plan of its
    # extended-local cells (the Krylov applies at 3, the rhs reduce at 6,
    # the stacked gather at 9)
    "sharded rank 0": {"slot_reduce": (1, 3), "slot_gather": (3,)},
    "halo rank 0": {"slot_reduce": (3, 6), "slot_gather": (3, 9)},
    # the DFG runs at scale (projection, macro path): diag C(w) reduced at 1
    # once a step, no gather
    "DFG 2D-2 at scale": {"slot_reduce": (1,)},
    "DFG 3D-1Z at scale": {"slot_reduce": (1,)},
}
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): device-memory
# bytes a second, and float32 operations a second outside the tensor cores.
# A kernel's bound is the larger of its bytes (each input read once, each
# output written once) and its operations over these.  A measured time
# more than 5% under its bound is a fault of the measurement, and fails.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The card's L2 cache (50 MB): a kernel whose bytes fit it reads them from
# there when called back to back, so the HBM bound does not hold it; where
# a path's plan is that small (the DFG 2D-2 run's), its share is logged, not
# held (`share(..., l2=True)`).
L2_BYTES = 50e6
# float64: the kernels' _f64 entry points move 8 bytes an element; their
# operations are bounded by the FP64 tensor-core peak, 67 TFLOP/s, the
# card's highest float64 rate (its FP64 vector rate is 34 TFLOP/s).
F64_OPS_PER_S = 67e12
MAX_SHARE = 1.05
# Kernels A-D in float64 against their plain versions, relative to max
# |plain|: the same f64 terms summed in another order (a few f64 ulps), or
# 0 for the copy.
KERNEL_RTOL64 = {"macro_matvec": 1e-12, "macro_build": 1e-12, "slot_reduce": 1e-12, "slot_gather": 0.0}
# torch.cuda._sleep counts clock cycles: at no more than 2 GHz, this many
# cycles last at least a second.
SPIN_CYCLES_PER_S = 2e9
# `cold_device_ms` reads this many bytes before each call: five times the
# L2, so that nothing the call reads is left there.
FLUSH_BYTES = 5 * L2_BYTES
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
# The `ensemble` entry point at its defaults (the JAX CLI's: the monolithic
# stepper, asimple, 64 members of 32,536 DoF on this mesh), driven for
# ENSEMBLE_CLI_STEPS steps in chunks of ENSEMBLE_CLI_CHUNK.
ENSEMBLE_CLI_MESH = dict(lc=0.08, nz=4)
ENSEMBLE_CLI_STEPS = 6
ENSEMBLE_CLI_CHUNK = 2
# Multi-device runs on the one card (local ranks under torch.distributed,
# both on the card, gloo: its halo slabs staged through host memory):
# `cylinder3d --shard-cells 2` at the CLI's defaults (SHARD_WARMUP +
# SHARD_TIMED steps in chunks of CLI_CHUNK) against the unsharded run on the
# card; the owned+halo projection step on 2 ranks at the same 142,692 DoF
# under __graft_entry__.py:149-159's halo configuration (HALO_STEPS steps)
# against the single-device step; `ensemble --shard-batch` at
# SHARD_BATCH_MEMBERS members.  The sharded and halo runs sum in another
# order than one device (partial reduces and an all-reduce, halo slabs): F
# counts may differ by SHARD_ITERS_SLACK a step; u and p of the sharded run
# are held to twice the monolithic float32 tolerance (MONO_CHECKS: each of
# the two float32 runs lies within it of the float64 solution), and the
# halo step's to HALO_RTOL: its solves stop at rtol 1e-5, so two converged
# runs differ by up to a few times that.
SHARD_RANKS = 2
SHARD_WARMUP = 2
SHARD_TIMED = 4
SHARD_ITERS_SLACK = 2
HALO_STEPS = 3
HALO_RTOL = 1e-3
SHARD_BATCH_MEMBERS = 4
# The explicit-convection run: the 46,928-DoF duct, where dt = 2e-4 is the
# explicit mode's measured-stable point (config.py TimeConfig); it
# diverges at 965k.
EXPLICIT_MESH = dict(lc=0.08, nz=6)
# Wide macro blocks: numerics.macro_u past 128, which the JAX package runs
# at any lane multiple of 128 (its profile, PERFORMANCE.md:120-132, measured
# U = 192 at c_blk 34 and U = 256 at c_blk 48 at 965k): name -> numerics
# changes.  Kernel B builds such a block's tile in bands of rows, kernel A
# past 256 slots in bands of columns.  Both widths run on the small duct
# (VARIANT_CHECKS, F64_CHECKS; with the macro options forced on and the
# warm-start pool's channels, WIDE_ON), on the 2D channel (SMALL_CHECKS),
# the 118,071-DoF channel at U = 256, and the single run at 965k (float32
# WARMUP_STEPS + TIMED_STEPS, float64 F64_WARMUP + F64_TIMED: the U = 128
# runs' counts, beside which each step's F and S are printed).
WIDE_MACRO = {"U=192": dict(macro_u=192, macro_cblk=34), "U=256": dict(macro_u=256, macro_cblk=48)}
# and a width past kernel A's 256 columns a CTA, whose kernels are checked
# and timed on the 965k plan (no run): (U, c_blk)
WIDE_PLAN_ONLY = (384, 48)
WIDE_ON = {"numerics": dict(macro_rhs="on", macro_wfuse="on", macro_split="on"), "precond": dict(f_warmstart=5)}


def wide_changes(name: str, on: bool = False) -> dict:
    """Config changes of WIDE_MACRO[name], with WIDE_ON's if `on`."""
    if not on:
        return {"numerics": WIDE_MACRO[name]}
    return {**WIDE_ON, "numerics": {**WIDE_MACRO[name], **WIDE_ON["numerics"]}}


# Small-duct variants, card f32 against CPU f64: name -> (config changes,
# mesh).  The IMEX one is a mixed partition (the reference's
# tests/test_imex.py:117-140 setting).
SMALL_DUCT = dict(lc=0.22, nz=3)
VARIANT_CHECKS = {
    "explicit": ({"time": dict(convection="explicit")}, SMALL_DUCT),
    "imex mixed": ({"time": dict(convection="imex", imex_umax=9.0, imex_cfl=0.07, dt=1e-3)}, SMALL_DUCT),
    "f_warmstart=2": ({"precond": dict(f_warmstart=2)}, SMALL_DUCT),
    "f_recycle=3": ({"precond": dict(f_recycle=3)}, SMALL_DUCT),
    # kernel A past 24 channels: the wide round's 27 (f_recycle=8), the rhs
    # pass's 18 and 27 (f_warmstart=5, 8)
    "f_recycle=8": ({"precond": dict(f_recycle=8)}, SMALL_DUCT),
    "f_warmstart=5": ({"precond": dict(f_warmstart=5)}, SMALL_DUCT),
    "f_warmstart=8": ({"precond": dict(f_warmstart=8)}, SMALL_DUCT),
    "macro_split": ({"numerics": dict(macro_split="on")}, SMALL_DUCT),
    "element F, rhs, D and G": ({"numerics": dict(
        f_apply="element", macro_rhs="off", macro_wfuse="off", grad_apply="element",
        div_apply="element")}, SMALL_DUCT),
    "coarse_solve=inv": ({"numerics": dict(coarse_solve="inv")}, SMALL_DUCT),
    "mg2_form=v11": ({"precond": dict(mg2_form="v11")}, SMALL_DUCT),
    **{f"macro {w}": (wide_changes(w), SMALL_DUCT) for w in WIDE_MACRO},
    **{f"macro {w}, macro options on, f_warmstart=5": (wide_changes(w, on=True), SMALL_DUCT)
       for w in WIDE_MACRO},
}
# Small-duct checks of the monolithic stepper, card f32 against CPU f64,
# 5 steps on SMALL_DUCT: name -> (precond changes to the cylinder3d CLI's
# defaults, tolerance relative to max |ref| as AGREE_RTOL is).  Each
# tolerance is at least twice the JAX package's own float32-against-float64
# spread on the same duct and steps, which
# tests/test_torch_monolithic_f32.py measures and holds under half of it
# (on the CPU: at most 2.7e-4 for the converging cases, 9.9e-3 for ayosida
# and 5.3e-2 for block_triangular, which run at maxiter 200 there).  The
# application itself is held far tighter (PRECOND_RTOL).
MONO_CHECKS = {
    "cylinder3d defaults (yosida)": ({}, 1e-3),
    "asimple": ({"kind": "asimple"}, 1e-3),
    "ayosida": ({"kind": "ayosida"}, 2e-2),
    "block_triangular": ({"kind": "block_triangular"}, 2e-1),
    "f_solver=richardson": ({"f_solver": "richardson"}, 1e-3),
    "f_solver=chebyshev": ({"f_solver": "chebyshev"}, 1e-3),
    "f_solver=pmg": ({"f_solver": "pmg"}, 1e-3),
    "s_solver=mg2_cg": ({"s_solver": "mg2_cg"}, 1e-3),
    "s_solver=spai_cg": ({"s_solver": "spai_cg"}, 1e-3),
    "s_solver=chebyshev": ({"s_solver": "chebyshev"}, 1e-3),
}
# The 2D, BDF2 and Ethier-Steinman small checks, card f32 against CPU f64:
# name -> (geometry, configuration, steps, tolerance relative to max |ref|
# as AGREE_RTOL is).  Geometries (`small_geometry`): "channel" the 2D
# channel cylinder_channel_2d(**SMALL_CHANNEL) with the cylinder2d problem
# (case 2), "duct" SMALL_DUCT with the 3D problem (case 2), "cube"
# cube_mesh(SMALL_CUBE) with the Ethier-Steinman problem (its Neumann face
# and initial state).  Configurations (`small_config`): ("cli", argv) the
# port's CLI at those flags, ("bench", changes) bench_config with changes.
# Each tolerance is at least twice the JAX package's own float32 spread on
# the same case, which tests/test_torch_slice_f32.py measures and holds
# under half of it.
SMALL_CHANNEL = dict(lc=0.12)
SMALL_CUBE = 4
SMALL_CHECKS = {
    "cylinder2d defaults (monolithic, asimple)": ("channel", ("cli", ["cylinder2d"]), AGREE_STEPS, 1e-4),
    "cylinder2d --fast": ("channel", ("cli", ["cylinder2d", "--fast"]), AGREE_STEPS, 1e-4),
    "cylinder2d bdf2 (monolithic)": (
        "channel", ("cli", ["cylinder2d", "--scheme", "bdf2"]), AGREE_STEPS, 1e-4),
    "cylinder2d --fast bdf2 (projection, macro)": (
        "channel", ("cli", ["cylinder2d", "--fast", "--scheme", "bdf2"]), AGREE_STEPS, 1e-4),
    "explicit bdf2 (AB2), small duct": (
        "duct", ("bench", {"time": dict(convection="explicit", scheme="bdf2")}), AGREE_STEPS, 1e-2),
    "Ethier-Steinman n=4, one step (convergence CLI)": ("cube", ("cli", ["convergence"]), 1, 1e-4),
    "cylinder2d --fast, macro U=256": (
        "channel", ("cli", ["cylinder2d", "--fast"], wide_changes("U=256")), AGREE_STEPS, 1e-4),
}
# Very wide blocks (Queue 3 fault 7), one or two blocks of 10-node cells
# with seeded slot tables: kernel A past the widths at which a block's
# whole [U, C] input panel fits one CTA's shared memory beside its
# narrowest column band (U = 2,336 at 24 float32 channels, the last that
# fits, 2,250 at 12 float64 ones, about 14,000 at 3), where it stages the
# panel in chunks of rows; kernel B past one band of two tiles' rows (at
# c_blk 20: U = 13,427 where U is not a multiple of 4, 26,854 where it
# is; at c_blk 48: 11,887 / 23,774), where float32 takes the one-tile
# design in row bands, and past one band of its whole rows (float32 past
# U = 29,056 where U is not a multiple of 4, float64 past 29,056), where it
# bands the columns too; U = 13,440 and 11,904 (multiples of 4) still run
# in one-row bands of two tiles.  Each is checked against its plain version
# (KERNELS, KERNEL_RTOL64) and timed with bound and share.
FAULT7 = (  # (U, c_blk, dtype, blocks, kernel A's channel counts)
    (2336, 20, "float32", 2, (24,)), (2560, 20, "float32", 2, (24,)), (2560, 20, "float64", 2, (12,)),
    (14464, 20, "float32", 2, (3,)), (14464, 20, "float64", 2, (3,)),
    (13440, 20, "float32", 2, (3,)), (13442, 20, "float32", 2, (3,)), (11904, 48, "float32", 2, (3,)),
    (11906, 48, "float32", 2, (3,)), (29058, 20, "float32", 1, (3,)), (29184, 20, "float64", 1, (3,)),
)
# The DFG validation runs (validation/dfg_validate.py, dfg3d_validate.py),
# the counterparts of scripts/dfg_validate.py and scripts/dfg3d_validate.py:
# their flags (`argv`) on top of the modules' defaults.  Default run: each
# on the small geometry with a ramp and a kick that switch off within
# AGREE_STEPS steps (DFG_SMALL: name -> (flags, tolerance relative to max
# |ref| as AGREE_RTOL is)), card float32 against CPU float64, and each
# module's `main` for DFG_MAIN_STEPS steps on the card, its summary finite;
# then each at scale, warm-up + timed steps through the solver `build`
# makes: 2D-2 on VALIDATION.md:10-11's mesh (53,049 DoF), 3D-1Z on the
# ladder's second rung (176k DoF).  The 2D-2 run's inlet reaches full speed
# in two steps, and its pressure after five, which its solves reach to
# rtol 1e-6 of the rhs, lies 1.45e-4 of max |p| from the float64 run's in
# the JAX package's own float32 run (tests/test_torch_dfg.py measures it
# and holds it under half of each tolerance); the card read 5.5e-5 and
# 2.2e-4 (kernel B's atomics sum in another order each run).
DFG_SMALL = {
    "2D-2": (["--lc", str(SMALL_CHANNEL["lc"]), "--dt", "2e-3", "--t-ramp", "0.004", "--t-kick", "0.008"], 5e-4),
    "3D-1Z": (["--lc", str(SMALL_DUCT["lc"]), "--nz", str(SMALL_DUCT["nz"]), "--dt", "2e-3", "--t-ramp", "0.004"],
              AGREE_RTOL),
}
DFG_MAIN_STEPS = 20
# `--only dfg_spread`: the small 2D-2 check DFG_SPREAD_RUNS times back to
# back (kernel B's atomics sum in another order each run), then once with
# kernel B's output on the card rounded to TF32's 10-bit mantissa (a
# lower-precision kernel), which must read above its tolerance: the port's
# CPU float32 run reads 1.3e-5 of max |p| sound and 2.5e-3 so rounded.
DFG_SPREAD_RUNS = 5
DFG_2D_SCALE = (["--lc", "0.015", "--dt", "1e-3", "--t-kick", "2.5", "--t-ramp", "1"], 10, 200)
DFG_3D_SCALE = (["--lc", "0.05", "--nz", "10"], 5, 50)
# `--only dfg_full` (or one run of it: dfg_re100, dfg_re200, dfg_3d1z): the
# full-length runs of VALIDATION.md through each module's `main`, each
# quantity held to its limit:
#   2D-2 at Re 100 (VALIDATION.md:10-11): inside the Schaefer-Turek interval
#   or within DFG_EDGE_RTOL of its edge, and within DFG_RE100_RTOL of the JAX
#   package's recorded value (VALIDATION.md:18-23);
#   Re 200 ("same mesh and workflow", VALIDATION.md:31-33): within
#   DFG_RE200_RTOL of the JAX package's tracked values (:36-41);
#   3D-1Z, the ladder of VALIDATION.md:85-93 at dt 4e-3 and t-end 3: each
#   rung held to the JAX package's float64 readings there (DFG_3D_JAX,
#   `dfg_3d_misses`), and at 313k and 706k DoF c_l and delta-p inside the
#   published intervals too, as VALIDATION.md:95 records them.
DFG_2D_FULL = {
    "dfg_re100": ["--re", "100", "--lc", "0.015", "--dt", "1e-3", "--t-end", "18", "--t-kick", "2.5",
                  "--t-ramp", "1", "--t-measure", "12"],
    "dfg_re200": ["--re", "200", "--lc", "0.015", "--dt", "5e-4", "--t-end", "9", "--t-kick", "2.5",
                  "--t-ramp", "1", "--t-measure", "5.5"],
}
DFG_RE100 = {  # key -> (published interval, the JAX package's value)
    "cd_max": ((3.22, 3.24), 3.211), "cl_max": ((0.99, 1.01), 0.981),
    "strouhal": ((0.295, 0.305), 0.3015), "delta_p_at_clmax": ((2.46, 2.50), 2.482),
}
DFG_EDGE_RTOL = 0.01
DFG_RE100_RTOL = 0.01
DFG_RE200 = {"cd_max": 3.248, "cl_max": 2.101, "cl_min": -2.152, "strouhal": 0.3217, "delta_p_mean": 10.77}
DFG_RE200_RTOL = 0.02
DFG_3D_LADDER = ((0.08, 6), (0.05, 10), (0.04, 12), (0.03, 16))
# The JAX package's readings on each rung of the ladder, (lc, nz) -> the
# tail window's mean c_d, c_l and delta-p and c_d's drift across the window:
# the package's solver at float64 on the CPU, built as
# scripts/dfg3d_validate.py builds it, 750 steps (tests/dfg3d_reference.py
# jax --dtype float64 --lc LC --nz NZ).  The port's CPU float64 runs of
# (0.08, 6) and (0.05, 10) repeat them step for step (c_d to 6e-11 of its
# value, the same iteration counts).  VALIDATION.md:89-92 prints the
# package's float32 readings on a TPU v5e; its "c_d drift < 0.2%" (:81-82)
# does not hold in float64 at 176k and 313k DoF.
DFG_3D_JAX = {
    (0.08, 6): dict(cd=5.649890152520193, cl=-0.003016920038226572, delta_p=0.18279980494143955,
                    cd_drift_rel=0.0016231238005498458),
    (0.05, 10): dict(cd=5.828418236734577, cl=0.004656082669762466, delta_p=0.17340352920399932,
                     cd_drift_rel=0.0020510103415479295),
    (0.04, 12): dict(cd=5.922714841967662, cl=0.008434896796003037, delta_p=0.1722301292989976,
                     cd_drift_rel=0.002132881574437363),
    (0.03, 16): dict(cd=6.031075125341075, cl=0.009478305434830935, delta_p=0.17096537766882902,
                     cd_drift_rel=0.001801236091548154),
}
DFG_3D_PUBLISHED = ((0.04, 12), (0.03, 16))  # rungs whose c_l and delta-p lie in the published intervals
# A float32 run's limits against DFG_3D_JAX: c_d and delta-p relative
# (DFG_3D_RTOL), c_l and the drift absolute, per rung (DFG_3D_ATOL).  Each
# is about twice the largest distance of a sound float32 reading from the
# float64 one (the card's fifteen float32 ladder runs and the JAX package's
# float32 CPU run), and below the distance of the same run with kernel B's
# card output rounded to TF32 (`--only dfg_3d_spread`, three runs) where
# that run moves the quantity past the sound spread.  c_d: sound up to
# 3.1e-5, TF32 1.4e-4 to 4.8e-3; delta-p: sound up to 5.1e-5, TF32 4.6e-4
# to 6.2e-3; c_l (a small difference of force integrals on c_d's scale):
# sound 2.5e-4, 1.8e-4, 3.0e-4 and 5.8e-4 from the coarsest rung up, TF32
# 3.7e-2, 1.0e-2, 1.4e-3 and 6.9e-3.  The drift is two single steps' c_d
# apart over their mean, and c_d jitters from step to step at the solves'
# tolerance (at 313k DoF moving the window's start one step moves the
# float64 drift from 0.2133% to 0.1875%): sound 4.5e-5, 2.5e-4, 4.4e-4 and
# 9.5e-4, TF32 1.7e-3, 4.2e-4, 8.8e-5 and 3.7e-4, so past the coarsest rung
# the drift's limit bounds only a gross departure and c_d, c_l and delta-p
# see the TF32 run.
DFG_3D_RTOL = 1e-4
DFG_3D_ATOL = {
    (0.08, 6): dict(cl=5e-4, cd_drift_rel=1e-4),
    (0.05, 10): dict(cl=4e-4, cd_drift_rel=5e-4),
    (0.04, 12): dict(cl=6e-4, cd_drift_rel=9e-4),
    (0.03, 16): dict(cl=1.2e-3, cd_drift_rel=2e-3),
}
# A float64 run's limit, every quantity (relative for c_d and delta-p):
# both packages' CPU float64 runs and the card's agree to 8.1e-12 at 176k
# DoF, and one Krylov iteration more or less at a step (the card's kernel B
# sums in its own order) moves c_d by about the solves' rtol, 1e-6.
DFG_3D_F64_TOL = 1e-6
# `--only dfg_drift`: the ladder's rung at 176,184 DoF, as dfg3d_validate
# builds it, in float32 twice (B's atomics) and in float64 (the same run
# without float32 rounding), each drift held as above, and in float32 to a
# later t-end (whether the drift shrinks as the flow settles; logged):
# (dtype, t-end) a run.
DFG_DRIFT_RUNG = (0.05, 10)
# `--only dfg_3d_spread`: the ladder DFG_3D_SPREAD_RUNS times in float32
# (kernel B's atomics sum in another order each run), then once with kernel
# B's output on the card rounded to TF32 (as `dfg_spread` plants it), the
# readings behind DFG_3D_RTOL and DFG_3D_ATOL: every sound run must meet
# its rung's limits and the TF32 run must miss them on every rung.
DFG_3D_SPREAD_RUNS = 3
DFG_DRIFT_RUNS = (("float32", 3.0), ("float32", 3.0), ("float64", 3.0), ("float32", 4.5))
# One `apply_precond` of each of the seven kinds and of each inner-solver
# case of MONO_CHECKS, card f32 against CPU f64 on the same seeded
# (w, v_u, v_p) on SMALL_DUCT, relative to max |ref| of z_u and of z_p.
# The port's own CPU float32 run reads at most 13.4 float32 epsilons
# (ayosida) from float64; one inner iteration fewer in each inner solve (the
# planted fault the check also runs, and must see) reads at least 4.8e-4
# (f_solver=pmg), 4000 epsilons.  The limit, 100 epsilons, lies between.
PRECOND_RTOL = 100 * 2.0 ** -23
# The projection paths on the per-step and the frozen ELL Schur (held to
# AGREE_RTOL like the other variants); the frozen ELL fallback is forced by
# a 1-byte limit on the banded form (`no_band`).
SCHUR_CHECKS = {
    "proj_schur=step": {"numerics": dict(proj_schur="step", schur_spmv="ell", grad_apply="ell")},
    "f_iters=4": {"precond": dict(f_iters=4)},
    "frozen ELL fallback": {},
}
# The ensemble's variants on the small duct, B = ENSEMBLE_AGREE_MEMBERS, card
# f32 against CPU f64: name -> (configuration, changes, tolerance relative to
# max |ref| as AGREE_RTOL is).  "ensemble" is ensemble_config: the projection
# variants, each member running what the single run of its nu runs (on the
# element fold), held to AGREE_RTOL as their single-run checks in
# VARIANT_CHECKS and SCHUR_CHECKS are; ("cylinder3d", precond) the
# cylinder3d CLI's configuration with those precond fields: the monolithic
# stepper, held to its MONO_CHECKS tolerance (the JAX package's own float32
# spread, measured by tests/test_torch_monolithic_f32.py).
ENSEMBLE_VARIANT_CHECKS = {
    "bdf2": ("ensemble", {"time": dict(scheme="bdf2")}, AGREE_RTOL),
    "explicit": ("ensemble", VARIANT_CHECKS["explicit"][0], AGREE_RTOL),
    "imex mixed": ("ensemble", VARIANT_CHECKS["imex mixed"][0], AGREE_RTOL),
    "f_recycle=3": ("ensemble", VARIANT_CHECKS["f_recycle=3"][0], AGREE_RTOL),
    "f_warmstart=2": ("ensemble", VARIANT_CHECKS["f_warmstart=2"][0], AGREE_RTOL),
    "s_recycle=2": ("ensemble", {"precond": dict(s_recycle=2)}, AGREE_RTOL),
    "coarse_solve=inv": ("ensemble", VARIANT_CHECKS["coarse_solve=inv"][0], AGREE_RTOL),
    "mg2_form=v11": ("ensemble", VARIANT_CHECKS["mg2_form=v11"][0], AGREE_RTOL),
    "proj_schur=step": ("ensemble", {"numerics": dict(proj_schur="step")}, AGREE_RTOL),
    "monolithic, asimple": (("cylinder3d", {"kind": "asimple"}), {}, MONO_CHECKS["asimple"][1]),
    "monolithic, yosida": (("cylinder3d", {}), {}, MONO_CHECKS["cylinder3d defaults (yosida)"][1]),
}
# The cylinder3d entry point at its defaults (142,692 DoF, float32) through
# the CLI: warm-up and timed steps, in chunks of CLI_CHUNK; its mesh.
CLI_WARMUP = 2
CLI_TIMED = 10
CLI_CHUNK = 2
CLI_MESH = dict(lc=0.05, nz=8)
# The cylinder2d entry point at its defaults (monolithic, asimple, 5,372
# DoF): warm-up and timed steps in chunks of CLI_CHUNK; `--fast` on the
# 118,071-DoF channel (FAST_2D_MESH) under bdf1 and bdf2 through the
# solver's run, FAST_2D_WARMUP + FAST_2D_TIMED steps each.
CLI_2D_WARMUP = 2
CLI_2D_TIMED = 20
CLI_2D_MESH = dict(lc=0.05)
FAST_2D_MESH = dict(lc=0.01)
FAST_2D_WARMUP = 10
FAST_2D_TIMED = 40
# The convergence entry point at its defaults (levels 2 4 8 16, float32):
# the last pair's rates must exceed the reference's bounds
# (tests/test_ethier_steinman.py:68-69), and the errors at CONV_CPU_LEVELS
# agree with the port's CPU float64 run within CONV_RTOL of their value
# (the f32 solution error, 6.6e-7 of max |u| in the reference's own run at
# n=4, against an L2 error of at least 4e-3 there).
CONV_MIN_RATES = {"L2": 2.4, "H1": 1.6}
CONV_CPU_LEVELS = (2, 4, 8)
CONV_RTOL = 5e-3
# The convergence entry point at --dtype float64 (the README's command for
# the reference's study): the same run as the CPU float64 one but for the
# order of its sums, so its errors are held to CONV_RTOL64 of the CPU's.
CONV_RTOL64 = 1e-8
# The float64 runs on the card: the single run at 965,265 DoF under
# bench_config("float64") (F64_WARMUP + F64_TIMED steps; kernels A and B in
# float64), and the cylinder3d entry point at --dtype float64 (CLI_WARMUP +
# CLI_TIMED steps).  Small-duct checks, card float64 against CPU float64
# (F64_CHECKS: name -> (configuration, changes), B = ENSEMBLE_AGREE_MEMBERS
# for "ensemble"): the same iteration counts, u and p within F64_RTOL of
# max |ref|; the CPU float64 state after F64_CARRY_STEPS steps, through a
# checkpoint, continues on the card.
F64_WARMUP = 10
F64_TIMED = 20
F64_RTOL = 1e-9
F64_CARRY_STEPS = 2
F64_CHECKS = {
    "bench (macro path: A and B)": ("bench", {}),
    "monolithic, yosida": ("cylinder3d", {}),
    "ensemble, B = 4": ("ensemble", {}),
    **{f"bench, macro {w}": ("bench", wide_changes(w)) for w in WIDE_MACRO},
    **{f"bench, macro {w}, macro options on, f_warmstart=5": ("bench", wide_changes(w, on=True))
       for w in WIDE_MACRO},
}
# numerics.fold_elem=False and spatial_reorder=False on the small duct,
# card float32 against CPU float64: name -> (configuration, changes,
# tolerance relative to max |ref|: AGREE_RTOL for the projection stepper,
# MONO_CHECKS' for the monolithic one).  The ensemble at
# scripts/bench_ensemble.py's settings runs again with fold_elem=False
# (ENSEMBLE_WARMUP + ENSEMBLE_TIMED steps): its peak device memory must lie
# below the folded ensemble's (the option exists to drop the per-member F_e).
UNFOLDED_CHECKS = {
    "fold_elem=False, projection": ("bench", {"numerics": dict(fold_elem=False)}, AGREE_RTOL),
    "fold_elem=False, monolithic asimple": (
        "asimple", {"numerics": dict(fold_elem=False)}, MONO_CHECKS["asimple"][1]),
    "spatial_reorder=False, projection": ("bench", {"numerics": dict(spatial_reorder=False)}, AGREE_RTOL),
    "spatial_reorder=False, monolithic": (
        "cylinder3d", {"numerics": dict(spatial_reorder=False)}, MONO_CHECKS["cylinder3d defaults (yosida)"][1]),
}
# The monolithic stepper at 965,265 DoF under bench.py's
# NS_BENCH_STEPPER=monolithic settings (bench.py:56-99: yosida, f_iters 4,
# s_iters 3, mg2_cg, restart 8, maxiter 60, tol_mode b).
MONO_RUN = {"time": dict(stepper="monolithic"), "precond": dict(f_iters=4)}
MONO_WARMUP = 2
MONO_TIMED = 5
# The 965k variant runs: name -> config changes (bench.py's environment
# knobs NS_BENCH_CONV, NS_BENCH_FWARM, NS_BENCH_MACRO_SPLIT,
# NS_BENCH_COARSE_SOLVE, NS_BENCH_RECYCLE, NS_BENCH_MG2).
IMEX_RUN = {"time": dict(convection="imex")}
ACCEL_RUNS = {
    "accel a (f_warmstart=2, macro_split, coarse inv)": {
        "precond": dict(f_warmstart=2), "numerics": dict(macro_split="on", coarse_solve="inv")},
    "accel b (f_recycle=4, V(1,1))": {"precond": dict(f_recycle=4, mg2_form="v11")},
}


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


def with_changes(cfg, changes: dict):
    """`cfg` with {part: {field: value}} replaced."""
    import dataclasses

    return dataclasses.replace(cfg, **{
        part: dataclasses.replace(getattr(cfg, part), **kw) for part, kw in changes.items()
    })


def cylinder3d_config(dtype: str = "float32", **precond):
    """The RunConfig of the port's `cylinder3d` CLI with no flags (the
    reference's: monolithic, yosida, f_iters 6, s_iters 30, restart 50,
    maxiter 200, tol_mode r0, precise dots) at `dtype`, with `precond`
    fields replaced."""
    import dataclasses

    from navierstokes_project_nm4pde_tpu_torch import cli

    cfg = cli._build_config(cli._parser().parse_args(["cylinder3d", "--dtype", dtype]), None)
    return dataclasses.replace(cfg, precond=dataclasses.replace(cfg.precond, **precond))


def small_config(spec, dtype: str = "float32"):
    """The RunConfig of a SMALL_CHECKS configuration at `dtype`: ("cli",
    argv[, changes]) or ("bench", changes)."""
    kind, arg, *changes = spec
    if kind == "cli":
        from navierstokes_project_nm4pde_tpu_torch import cli

        cfg = cli._build_config(cli._parser().parse_args([*arg, "--dtype", dtype]), None)
        return with_changes(cfg, changes[0]) if changes else cfg
    return with_changes(bench_config(dtype), arg)


def small_geometry(name: str):
    """(mesh, problem) of a SMALL_CHECKS geometry (the port's)."""
    from navierstokes_project_nm4pde_tpu_torch import mesh, models

    if name == "channel":
        return mesh.cylinder_channel_2d(**SMALL_CHANNEL), models.Cylinder2DProblem(test_case=2)
    if name == "duct":
        return mesh.cylinder_duct_3d(**SMALL_DUCT), models.Cylinder3DProblem(test_case=2)
    return mesh.cube_mesh(SMALL_CUBE), models.EthierSteinmanProblem()


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


def device_ms(fn, reps: int) -> float:
    """Device time of one call of fn(): CUDA events around `reps` calls
    queued behind a spin kernel (`torch.cuda._sleep`) that outlasts their
    enqueue, so that the device runs them back to back and the events time
    its work, not the host's (for a call that launches several kernels,
    with the gaps between its launches).  A reading whose spin ended before
    the last call was queued is discarded and taken again behind a longer
    spin; fails after three such."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin for twice the host's time of the same calls, and at least 1 ms;
    # if the host was slower this time (a shared machine), again with a
    # spin four times as long
    for attempt in range(3):
        torch.cuda._sleep(int(2 * 4**attempt * max(host_s, 1e-3) * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        if not start.query():
            end.synchronize()
            return start.elapsed_time(end) / reps
        torch.cuda.synchronize()
    fail("device_ms: the spin kernel ended before the last call was queued, three times")


def graph_device_ms(fn, reps: int) -> float | None:
    """Device time of one call of fn(), for a call with more launches than
    the queue behind `device_ms`'s spin holds: fn captured once as a CUDA
    graph, and `device_ms` of its replay (one launch each).  None if fn
    cannot be captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        log(f"graph_device_ms: capture failed: {e}")
        torch.cuda.synchronize()
        return None
    return device_ms(graph.replay, reps)


def kernel_times(fn, plain, lib, reps: int) -> dict:
    """Call and device times of a kernel, its plain version and the one
    PyTorch call that computes the same function, in turns."""
    return dict(
        ms=time_ms(fn, reps), plain_ms=time_ms(plain, reps), library_ms=time_ms(lib, reps),
        device_ms=device_ms(fn, reps), plain_device_ms=device_ms(plain, reps),
        lib_device_ms=device_ms(lib, reps),
    )


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> dict:
    """The least ms the card could take to move `nbytes` and do `ops`
    operations at `ops_per_s` (f32's peak, or F64_OPS_PER_S), and which of
    the two bounds it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return dict(
        bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
        bytes=nbytes, ops=ops,
    )


def share(name: str, b: dict, dev_ms: float, l2: bool = False) -> float | None:
    """bound / device time; fails above MAX_SHARE.  With `l2`, a kernel whose
    bytes fit L2_BYTES gets no share (None): the ratio is logged only."""
    s = b["bound_ms"] / dev_ms
    if l2 and b["bytes"] <= L2_BYTES:
        log(f"  {name}: {b['bytes'] / 1e6:.1f} MB fit the L2 cache: {s:.3f} of the HBM bound, not held")
        return None
    if not s <= MAX_SHARE:
        fail(f"{name}: device time {dev_ms:.4f} ms is {s:.3f} of its {b['bound_ms']:.4f} ms bound")
    return s


def fmt_times(t: dict, b: dict) -> str:
    return (f"call {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms; "
            f"device {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms, "
            f"library {t['lib_device_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes'] / 1e6:.1f} MB, {b['ops'] / 1e9:.3f} Gop): "
            f"{b['bound_ms'] / t['device_ms']:.1%} of bound on device")


def compare(name, out, ref) -> float:
    """Max abs error of a kernel's output against its plain version; fails
    above the kernel's tolerance (relative to max |plain|; KERNEL_RTOL64 in
    float64) or if the two differ in type."""
    import torch

    if out.dtype != ref.dtype:
        fail(f"{name}: the kernel returned {out.dtype}, its plain version {ref.dtype}")
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    tol = KERNEL_RTOL64[name] if ref.dtype == torch.float64 else KERNELS[name][2]
    log(f"  {name} ({ref.dtype}): max abs err {err:.3e}, max rel err {rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        fail(f"{name} disagrees with its plain version: rel err {rel:.3e} > {tol:g}")
    return err


def check_kernels(solver, reps: int, widths=MATVEC_WIDTHS, l2: bool = False) -> dict:
    """Kernels A (at `widths` channels) and B against their plain versions
    on the solver's own plan, with seeded random inputs in the solver's
    dtype; returns per-kernel records (launch counts filled in later).
    `l2` as in `share`."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    mp, dev, dtype = solver.macro, solver.device, solver.dtype
    size = torch.finfo(dtype).bits // 8
    peak = F64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
    nloc = mp.lidx.shape[2]
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    F_e = torch.randn((mp.E, nloc, nloc), generator=gen, device=dev, dtype=dtype)
    log(f"kernel B macro_build: F_e {tuple(F_e.shape)}, lidx {tuple(mp.lidx.shape)} -> [{mp.B}, {mp.U}, {mp.U}]")
    FtT = mb.macro_build(F_e, mp.lidx, mp.B, mp.U)
    ref = mb.macro_build_plain(F_e, mp.lidx, mp.B, mp.U)
    err_b = compare("macro_build", FtT, ref)
    del ref
    # the library call: index_add_ into zeros, its flat index built once
    UU = mp.U * mp.U
    li = mp.lidx.to(torch.int64)
    flat = (torch.arange(mp.B, device=dev).view(-1, 1, 1, 1) * UU
            + li[:, :, None, :] * mp.U + li[:, :, :, None]).reshape(-1)[: mp.E * nloc * nloc]
    F_flat, lib_out = F_e.reshape(-1), torch.empty(mp.B * UU, device=dev, dtype=dtype)
    t = kernel_times(
        lambda: mb.macro_build(F_e, mp.lidx, mp.B, mp.U),
        lambda: mb.macro_build_plain(F_e, mp.lidx, mp.B, mp.U),
        lambda: lib_out.zero_().index_add_(0, flat, F_flat), reps,
    )
    b = bound((F_e.numel() + FtT.numel()) * size + mp.lidx.numel() * 4, F_e.numel(), peak)
    t["share"] = share(f"macro_build {dtype}", b, t["device_ms"], l2)
    log(f"  macro_build ({dtype}): {fmt_times(t, b)}")
    rec["macro_build"] = dict(err=err_b, **t, **b)
    del F_e, F_flat, flat, lib_out, li
    return _check_matvec(rec, FtT, mp, gen, widths, reps, l2)


def _check_matvec(rec: dict, FtT, mp, gen, widths, reps: int, l2: bool = False) -> dict:
    """Kernel A's part of `check_kernels`: at each of `widths` channels,
    checked and timed with bound and share.  A payload past 24 channels
    runs as ceil(C / 24) launches, each reading FtT once."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    dev, dtype = FtT.device, FtT.dtype
    size = FtT.element_size()
    peak = F64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
    errs, times, bounds = [], {}, {}
    key = "macro_matvec" if dtype == torch.float32 else "macro_matvec_f64"  # its entry point's count
    for C in widths:
        x_b = torch.randn((mp.B, mp.U, C), generator=gen, device=dev, dtype=dtype)
        before = mb.launch_counts[key]
        y = mb.macro_matvec(FtT, x_b)
        reads = mb.launch_counts[key] - before
        if reads != len(mb.matvec_splits(C, mb.max_channels(dtype))):
            fail(f"macro_matvec {dtype} C={C}: {reads} launches counted under {key}")
        log(f"kernel A macro_matvec: FtT {tuple(FtT.shape)} x_b {tuple(x_b.shape)}: "
            f"{reads} launch(es), FtT read {reads} time(s)")
        errs.append(compare("macro_matvec", y, mb.macro_matvec_plain(FtT, x_b)))
        del y
        t = times[C] = kernel_times(
            lambda: mb.macro_matvec(FtT, x_b), lambda: mb.macro_matvec_plain(FtT, x_b),
            lambda: torch.bmm(FtT.transpose(1, 2), x_b), reps,
        )
        t["ftt_reads"] = reads
        b = bounds[C] = bound((FtT.numel() + 2 * x_b.numel()) * size, 2.0 * FtT.numel() * C, peak)
        t["share"] = share(f"macro_matvec {dtype} C={C}", b, t["device_ms"], l2)
        gbs = FtT.numel() * size / t["device_ms"] / 1e6
        log(f"  macro_matvec ({dtype}) C={C}: {fmt_times(t, b)} ({gbs:.1f} GB/s of values on device)")
        del x_b
    C0 = widths[0]
    rec["macro_matvec"] = dict(
        err=max(errs), **times[C0], **bounds[C0],
        widths={C: dict(device_ms=times[C]["device_ms"], bound_ms=bounds[C]["bound_ms"],
                        share=times[C]["share"], plain_device_ms=times[C]["plain_device_ms"],
                        library_ms=times[C]["library_ms"], lib_device_ms=times[C]["lib_device_ms"],
                        ftt_reads=times[C]["ftt_reads"])
                for C in widths},
    )
    return rec


def add_macro_shapes(rec: dict, label: str, solver, widths, reps: int, l2: bool = False) -> None:
    """Kernels A (at `widths`) and B checked and timed on another path's
    macro plan, added to their records under "shapes"; `l2` as in `share`."""
    mp = solver.macro
    label = f"{label}, B={mp.B} U={mp.U} c_blk={mp.c_blk} nloc={mp.lidx.shape[2]}"
    r = check_kernels(solver, reps, widths, l2=l2)
    keys = ("device_ms", "bound_ms", "share", "plain_device_ms", "library_ms", "lib_device_ms")
    rec["macro_build"]["err"] = max(rec["macro_build"]["err"], r["macro_build"]["err"])
    rec["macro_build"].setdefault("shapes", {})[label] = {k: r["macro_build"][k] for k in keys}
    rec["macro_matvec"]["err"] = max(rec["macro_matvec"]["err"], r["macro_matvec"]["err"])
    for C, t in r["macro_matvec"]["widths"].items():
        rec["macro_matvec"].setdefault("shapes", {})[f"{label}, C={C}"] = t


def check_slot_kernels(plans, widths: dict, reps: int, dtype=None) -> dict:
    """Kernels C and D against their plain versions on element `plans`,
    at `widths` ({kernel: channel counts}), with seeded random inputs in
    `dtype` (None: float32), then timed; returns {kernel: dict(err=,
    widths={C: times and bound})}."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    dev, dtype = plans.gather.device, dtype or torch.float32
    size = torch.finfo(dtype).bits // 8
    peak = F64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
    gen = torch.Generator(device=dev).manual_seed(1)
    # index bytes each kernel reads: C the CSR order and row offsets, D the
    # flat slot index (all int64)
    idx_bytes = {
        "slot_reduce": (plans.reduce.perm.numel() + plans.reduce.offsets.numel()) * 8,
        "slot_gather": plans.gather.numel() * 8,
    }
    # kernel -> (wrapper, plain version, library call, payload rows)
    kernels = {
        "slot_reduce": (oh.onehot_reduce, oh.onehot_reduce_plain,
                        lambda x: torch.zeros((plans.n_rows, x.shape[1]), device=dev, dtype=dtype).index_add_(
                            0, plans.gather, x),
                        plans.n_slots),
        "slot_gather": (oh.onehot_gather, oh.onehot_gather_plain,
                        lambda x: x.index_select(0, plans.gather), plans.n_rows),
    }
    rec = {}
    for name, Cs in widths.items():
        fn, plain, lib, rows = kernels[name]
        errs, per_width = [], {}
        for C in Cs:
            x = torch.randn((rows, C), generator=gen, device=dev, dtype=dtype)
            log(f"kernel {name}: {dtype} payload {tuple(x.shape)}, {plans.n_slots} slots -> {plans.n_rows} rows")
            errs.append(compare(name, fn(plans, x), plain(plans, x)))
            t = kernel_times(lambda: fn(plans, x), lambda: plain(plans, x), lambda: lib(x), reps)
            # every slot row once, every node row once; C's sums are its operations
            b = bound(
                (plans.n_slots + plans.n_rows) * C * size + idx_bytes[name],
                plans.n_slots * C if name == "slot_reduce" else 0, peak,
            )
            t["share"] = share(f"{name} {dtype} C={C}", b, t["device_ms"])
            gbs = (plans.n_slots + plans.n_rows) * C * size / t["device_ms"] / 1e6
            log(f"  {name} ({dtype}) C={C}: {fmt_times(t, b)} ({gbs:.1f} GB/s on device)")
            per_width[C] = dict(**t, **b)
            del x
        rec[name] = dict(err=max(errs), widths=per_width)
    return rec


def add_slot_shapes(rec: dict, label: str, plans, reps: int, dtype=None, base=None) -> None:
    """Kernels C and D checked and timed on a path's plan
    (SLOT_SHAPES[label]) in `dtype`, added to their records in `rec` under
    "shapes"; with `base` (a channel count) the records are made here, their
    own numbers those at `base` channels."""
    for name, r in check_slot_kernels(plans, SLOT_SHAPES[label], reps, dtype).items():
        if base is not None:
            rec[name] = dict(err=0.0, **r["widths"][base])
        kr = rec[name]
        kr["err"] = max(kr["err"], r["err"])
        for C, t in r["widths"].items():
            kr.setdefault("shapes", {})[f"{label}, {plans.n_slots} slots, C={C}"] = {
                k: t[k] for k in ("device_ms", "bound_ms", "share", "plain_device_ms",
                                  "library_ms", "lib_device_ms")
            }


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
    share("sgemm_probe", b_e, t_e["device_ms"])
    log(f"  sgemm_probe: {fmt_times(t_e, b_e)} (plain and library: cuBLAS, TF32 off); on device "
        f"{flop / t_e['device_ms'] / 1e9:.2f} TFLOP/s f32 FMA, plain {flop / t_e['plain_device_ms'] / 1e9:.2f}")
    b_g = []
    for (src, ci, _), t in zip(cases, t_g):
        n_el, w = src.numel(), src.shape[1]
        # the source elements this index reads (each once), the index, the output
        used = torch.unique(ci.idx64 * w + torch.arange(w, device=dev)).numel()
        b_g.append(bound((used + 2 * n_el) * 4, 0))
        share(f"column_gather {tuple(src.shape)}", b_g[-1], t["device_ms"])
        log(f"  column_gather {tuple(src.shape)}: {fmt_times(t, b_g[-1])}; on device "
            f"{t['device_ms'] / n_el * 1e6:.4f} ns/elem, plain {t['plain_device_ms'] / n_el * 1e6:.4f}")
    return {
        "sgemm_probe": dict(err=err_e, launches=launches["sgemm_probe"], **t_e, **b_e),
        "column_gather": dict(
            err=max(e for _, _, e in cases), launches=launches["column_gather"], **t_g[1], **b_g[1]
        ),
    }


def check_small_duct(device, name: str = "bench", changes=None, mesh_kw=SMALL_DUCT,
                     config=bench_config, rtol: float = AGREE_RTOL, card_dtype: str = "float32") -> None:
    """`check_small` on a small duct of the 3D problem under `config(dtype)`
    with `changes`."""
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem

    check_small(device, f"small duct, {name}", cylinder_duct_3d(**mesh_kw), Cylinder3DProblem(test_case=2),
                lambda dtype: with_changes(config(dtype), changes or {}), AGREE_STEPS, rtol, card_dtype)


def small_errors(out: dict, ref: dict) -> dict:
    """Max error over the steps of each of u, p, c_d, c_l, delta_p relative
    to max |ref| (c_l to max |c_d|: lift is a small difference of force
    integrals on drag's scale); a quantity the problem does not have (all
    zero, as the Ethier-Steinman run's forces) is left out."""
    import numpy as np

    errs = {}
    for k in ref:
        scale = np.abs(ref["c_d" if k == "c_l" else k]).max()
        if scale > 0:
            errs[k] = np.abs(out[k] - ref[k]).max() / scale
    return errs


def check_small(device, name: str, mesh, problem, config, steps: int, rtol: float,
                card_dtype: str = "float32") -> dict:
    """The port on the card (`card_dtype`, kernels) against the port on the
    CPU (f64, plain versions): `steps` steps under `config(dtype)`, every
    quantity of `small_errors` within `rtol`; in float64 on both, also the
    same F and S counts.  Returns the errors."""
    from navierstokes_project_nm4pde_tpu_torch.models import NavierStokesSolver

    (sg, dg), (sc, dc) = (
        NavierStokesSolver(mesh, problem, config(dtype), device=dev).run(steps)
        for dev, dtype in ((device, card_dtype), ("cpu", "float64"))
    )
    log(f"{name} ({sc.u.shape[0]} velocity nodes, card {card_dtype}), {steps} steps: "
        f"F iters card {dg.iters_f.tolist()} cpu {dc.iters_f.tolist()}, "
        f"S iters card {dg.iters_s.tolist()} cpu {dc.iters_s.tolist()}")
    if card_dtype == "float64" and not (
        (dg.iters_f == dc.iters_f).all() and (dg.iters_s == dc.iters_s).all()
    ):
        fail(f"{name}: the float64 runs on the card and the CPU took different iteration counts")
    ref = {k: getattr(sc, k).numpy() for k in ("u", "p")}
    out = {k: getattr(sg, k).double().cpu().numpy() for k in ("u", "p")}
    for k in ("c_d", "c_l", "delta_p"):
        ref[k], out[k] = getattr(dc, k), getattr(dg, k)
    errs = small_errors(out, ref)
    log("  max err vs cpu f64, relative to max |ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        if not v <= rtol:
            fail(f"{name}: {k} err {v:.3e} > {rtol:g} of max |ref|")
    return errs


@contextlib.contextmanager
def no_band():
    """The port's frozen S1 with a 1-byte limit on its banded form: every
    band is too wide, so the stepper takes its ELL fallback."""
    from navierstokes_project_nm4pde_tpu_torch.models import base
    from navierstokes_project_nm4pde_tpu_torch.ops.banded import build_banded_schur

    base.build_banded_schur = functools.partial(build_banded_schur, max_bytes=1)
    try:
        yield
    finally:
        base.build_banded_schur = build_banded_schur


def check_small_monolithic(device) -> None:
    """The monolithic stepper (MONO_CHECKS) and the projection paths on the
    per-step and the frozen ELL Schur (SCHUR_CHECKS), card against CPU on
    the small duct."""
    for name, (precond, rtol) in MONO_CHECKS.items():
        check_small_duct(device, f"monolithic, {name}", config=functools.partial(
            cylinder3d_config, **precond), rtol=rtol)
    for name, changes in SCHUR_CHECKS.items():
        with no_band() if name == "frozen ELL fallback" else contextlib.nullcontext():
            check_small_duct(device, name, changes)


def check_small_precond(device) -> None:
    """One `apply_precond` of each kind and inner-solver case on the card (f32,
    kernels C and D in every F apply) against the CPU (f64) on the same
    seeded inputs, to PRECOND_RTOL; and the planted fault (one inner
    iteration fewer in each inner solve) on the card, which must read above
    it wherever the kind runs an inner solve."""
    import dataclasses

    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
    from navierstokes_project_nm4pde_tpu_torch.precond import blocks

    mesh = cylinder_duct_3d(**SMALL_DUCT)
    # f_solver pmg and s_solver spai_cg: each operator holds the P2 -> P1
    # transfers and the SPAI values, so that every case runs on one pair
    solvers = {
        dev: NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cylinder3d_config(
            dtype, f_solver="pmg", s_solver="spai_cg"), device=dev)
        for dev, dtype in ((device, "float32"), ("cpu", "float64"))
    }
    sc = solvers["cpu"]
    n, n_p = sc.space.n_unodes, sc.space.n_pnodes
    rng = np.random.default_rng(7)
    w = rng.uniform(-2.25, 2.25, size=(n, 3))  # the inflow's peak speed
    v_u, v_p = rng.normal(size=(n, 3)), rng.normal(size=n_p)
    nu, dt = sc.problem.nu, sc.config.time.dt
    base = cylinder3d_config().precond

    def apply(s, pc):
        T = lambda a: torch.as_tensor(a, dtype=s.dtype, device=s.device)  # noqa: E731
        conv = ops.convection_setup(s.op, T(w), fold=(nu, dt))
        st = blocks.build_precond_state(s.op, nu, dt, conv, pc.kind, s_solver=pc.s_solver,
                                        f_solver=pc.f_solver, f_lam=s._f_lam0)
        return [z.double().cpu().numpy() for z in blocks.apply_precond(
            pc.kind, pc, s.op, st, nu, dt, T(v_u), T(v_p))]

    def err(out, ref):
        return max(float(np.abs(o - r).max() / np.abs(r).max()) for o, r in zip(out, ref))

    cases = {
        **{k: {"kind": k} for k in blocks.PRECOND_KINDS},
        **{k: v for k, (v, _) in MONO_CHECKS.items() if v and "kind" not in v},
    }
    rows = []
    for name, changes in cases.items():
        pc = dataclasses.replace(base, **changes)
        ref = apply(sc, pc)
        e = err(apply(solvers[device], pc), ref)
        fault = dataclasses.replace(pc, f_iters=pc.f_iters - 1, s_iters=pc.s_iters - 1)
        e_fault = err(apply(solvers[device], fault), ref)
        rows.append(f"{name} {e:.3e} (fault {e_fault:.3e})")
        if not e <= PRECOND_RTOL:
            fail(f"apply_precond, {name}: card f32 err {e:.3e} > {PRECOND_RTOL:.3e} of max |ref|")
        if pc.kind not in ("identity", "block_identity") and not e_fault > PRECOND_RTOL:
            fail(f"apply_precond, {name}: the planted fault reads {e_fault:.3e}, "
                 f"within the {PRECOND_RTOL:.3e} limit")
    log(f"small duct, one apply_precond each, card f32 against cpu f64 (limit {PRECOND_RTOL:.3e} "
        f"of max |ref|; one inner iteration fewer in brackets): " + "; ".join(rows))


def check_small_ensemble(device, name: str = "bench", config=ensemble_config, changes=None,
                         rtol: float = AGREE_RTOL, card_dtype: str = "float32") -> None:
    """The port's ensemble on the card (`card_dtype`, kernels C and D)
    against the same ensemble on the CPU (f64, plain versions) on a small
    duct under `config(dtype)` with `changes`, each member held to `rtol` of
    its own max |ref|; in float64 on both, also the same per-member
    counts."""
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
            NavierStokesSolver(mesh, problem, with_changes(config(dtype), changes or {}), device=dev),
            nus, AGREE_STEPS,
        )
        for dev, dtype in ((device, card_dtype), ("cpu", "float64"))
    )
    log(f"small-duct ensemble, {name} (B={len(nus)}, {sc.u.shape[0]} velocity nodes, card {card_dtype}), "
        f"{AGREE_STEPS} steps: F iters card {dg.iters_f.tolist()} cpu {dc.iters_f.tolist()}, "
        f"S iters card {dg.iters_s.tolist()} cpu {dc.iters_s.tolist()}")
    if card_dtype == "float64" and not (
        (dg.iters_f == dc.iters_f).all() and (dg.iters_s == dc.iters_s).all()
    ):
        fail(f"small-duct ensemble, {name}: the float64 runs on the card and the CPU took different counts")
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
        if not v <= rtol:
            fail(f"small-duct ensemble, {name}: {k} err {v:.3e} > {rtol:g} of max |ref|")


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


def check_run(path: str, solver, state, d, launches: dict, any_maxiter: bool = True) -> None:
    """Fail on a non-finite result, a timed step at maxiter (any member;
    with any_maxiter=False, only every step), or a kernel of the path that
    was never launched."""
    import numpy as np

    maxit = solver.config.solver.maxiter
    for k in ("c_d", "c_l", "delta_p", "residual"):
        if not np.all(np.isfinite(getattr(d, k))):
            fail(f"{path}: non-finite {k} in the timed steps")
    if not (np.all(np.isfinite(state.u.cpu().numpy())) and np.all(np.isfinite(state.p.cpu().numpy()))):
        fail(f"{path}: non-finite u or p after the timed steps")
    at_max = (d.iters_f >= maxit) | (d.iters_s >= maxit)
    if np.any(at_max) if any_maxiter else np.all(at_max):
        fail(f"{path}: {'a' if any_maxiter else 'every'} timed step reached maxiter={maxit}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{path}: the path never launched kernel {name}")


def drive_single(path: str, solver, warmup: int, timed: int, kernels, any_maxiter: bool = True):
    """A single-run path through `solver.run`: `warmup` steps from rest,
    then `timed` steps, each kernel's count set to 0 just before them and
    read just after.  Logs steps/s, the per-step median and quartiles, F
    and S a step, peak device memory and the launches (kernel A's by
    channel count), and fails per `check_run` on the `kernels` the path
    must launch.  Returns (state, diagnostics, ms per step, launches)."""
    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    dev = solver.device
    t0 = time.perf_counter()
    state, dw = solver.run(warmup)
    torch.cuda.synchronize()
    log(f"{path}: warm-up: {warmup} steps in {time.perf_counter() - t0:.2f} s; "
        f"F iters {dw.iters_f.tolist()}, S iters {dw.iters_s.tolist()}")
    torch.cuda.reset_peak_memory_stats(dev)
    mb.reset_launch_counts()
    oh.reset_launch_counts()
    state, d, step_ms = timed_steps(lambda st, k: solver.run(k, state=st), state, timed)
    launches = {**mb.launch_counts, **oh.launch_counts}
    channels = dict(sorted(mb.matvec_channels.items()))
    q = np.percentile(step_ms, [25, 50, 75])
    log(f"{path}: timed: {timed} steps in {sum(step_ms) / 1e3:.4f} s: "
        f"{1e3 * timed / sum(step_ms):.4f} steps/s, {sum(step_ms) / timed:.4f} ms/step mean; "
        f"per step median {q[1]:.4f} ms, quartiles {q[0]:.4f} / {q[2]:.4f} ms, "
        f"max {max(step_ms):.4f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    log(f"  ms per step {[round(t, 3) for t in step_ms]}")
    log(f"  F iters per step {d.iters_f.tolist()} (mean {d.iters_f.mean():.2f})")
    log(f"  S iters per step {d.iters_s.tolist()} (mean {d.iters_s.mean():.2f})")
    log(f"  last step: c_d {d.c_d[-1]:.8g}, c_l {d.c_l[-1]:.8g}, delta_p {d.delta_p[-1]:.8g}, t {state.t:.6g}")
    log(f"  kernel launches in the timed run: {launches}; per step "
        + ", ".join(f"{k} {v / timed:.2f}" for k, v in launches.items())
        + f"; kernel A launches by channel count {channels}")
    check_run(path, solver, state, d, {k: launches[k] for k in kernels}, any_maxiter)
    return state, d, step_ms, launches


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def cold_device_ms(fn, reps: int) -> float:
    """Device time of one call of fn() that finds nothing of its operands in
    L2, as inside the pressure CG, where a Schur matvec streams its band
    between two coarse solves: each of `reps` calls between two CUDA
    events, after a read of FLUSH_BYTES (a read, as the band's: a write
    would leave L2 dirty, and the call would pay for writing it back), all
    queued behind a spin that outlasts their enqueue (taken again behind a
    longer spin where it did not; fails after three such)."""
    import torch

    flush = torch.zeros(int(FLUSH_BYTES) // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        flush.sum()
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    for attempt in range(3):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(int(2 * 4**attempt * max(host_s, 1e-3) * SPIN_CYCLES_PER_S))
        for start, end in events:
            flush.sum()
            start.record()
            fn()
            end.record()
        if not events[0][0].query():
            torch.cuda.synchronize()
            return sum(start.elapsed_time(end) for start, end in events) / reps
        torch.cuda.synchronize()
    fail("cold_device_ms: the spin kernel ended before the last call was queued, three times")


def coarse_solve_times(label: str, solver, cols: int, reps: int) -> dict:
    """The frozen coarse solve of one pressure-CG iteration at the solver's
    coarse size and `cols` columns (the duct's 1, the sweep's 64), from what
    `FrozenSchur` holds (`cho_w`: W = L^-1 and W^T, packed): the
    `coarse_solve` kernel against its plain version, `torch.cholesky_solve`
    on L = W^-1 (the library call, and the solve before the kernel) and one
    product with the dense inverse W^T W (coarse_solve "inv").  Call ms;
    device ms back to back (`device_ms`: W stays in L2) and with L2 emptied
    before each call (`cold_device_ms`), the latter held to the benchmark
    reader's bound (`nsbench/metrics/coarse_solve_roofline.py`: the
    triangle read twice, the coarse vector in and out).  Fails where the
    kernel misses its plain version by more than 1e-5 of max |plain|
    (1e-12 in float64).  Logs and returns the record."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import coarse

    W = solver.proj_schur.cho_w
    nc, dev, dt = W.shape[0], W.device, W.dtype
    W64 = torch.tril(W[:, :nc]).double()
    L = torch.linalg.solve_triangular(W64, torch.eye(nc, dtype=torch.float64, device=dev), upper=False).to(dt)
    Sc_inv = (W64.T @ W64).to(dt)
    rc = torch.randn((nc, cols), generator=torch.Generator(device=dev).manual_seed(3), device=dev, dtype=dt)
    rc = rc - rc.mean(dim=0)
    fns = dict(
        kernel=lambda: coarse.coarse_solve(W, rc),
        plain=lambda: coarse.coarse_solve_plain(W, rc),
        cholesky_solve=lambda: torch.cholesky_solve(rc, L, upper=False),
        inverse=lambda: Sc_inv @ rc,
    )
    out = {k: fn() for k, fn in fns.items()}
    scale = float(out["plain"].abs().max())
    err = float((out["kernel"] - out["plain"]).abs().max()) / scale
    if not err <= (1e-12 if dt == torch.float64 else 1e-5):
        fail(f"coarse_solve {label}: the kernel misses its plain version by {err:.3e} of max |plain|")
    s = W.element_size()
    b = bound(nc * (nc + 1) * s + 2 * nc * cols * s, 2 * nc * nc * cols,
              F64_OPS_PER_S if dt == torch.float64 else F32_OPS_PER_S)
    r = dict(nc=nc, cols=cols, dtype=str(dt).replace("torch.", ""), max_rel_err=err,
             rel_diff_cholesky_solve=float((out["kernel"] - out["cholesky_solve"]).abs().max()) / scale,
             **{f"{k}_ms": time_ms(fn, reps) for k, fn in fns.items()},
             **{f"{k}_warm_device_ms": device_ms(fn, reps) for k, fn in fns.items()},
             **{f"{k}_device_ms": cold_device_ms(fn, reps) for k, fn in fns.items()}, **b)
    r["share"] = share(f"coarse_solve {label}", b, r["kernel_device_ms"])
    log(f"coarse_solve {label}: {json.dumps(r)}")
    return r


def member_product_times(solver, reps: int) -> list:
    """Kernel G (`onehot.member_product`) at the ensemble solver's element
    plan (E cells of nloc nodes, 3 channels, ENSEMBLE_MEMBERS members), in
    float32 and float64, with seeded random inputs: on node rows with the
    gather fused in (`apply_F`'s mode) and on the velocity's channel slice
    of a stacked [hist | u0 | w] gather (the rhs pass's).  Each against its
    plain version (kernel D's gather and the multiply-add chain, as `apply_F`
    ran before; the chain alone), held to 1e-6 of max |plain| (1e-13 in
    float64), then timed beside its bound (F_e read once, y written once,
    and the input once: the node rows and their int64 index, or the slice)
    and the library call `torch.einsum("jeib,ejcb->eicb", F_e, x_e)`, which
    the port never calls.  The element pass around it (kernel C's reduce
    after kernel G on node rows, against D, the chain and C) is timed too.
    Logs and returns the records."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    plans, B = solver.op.onehot, ENSEMBLE_MEMBERS
    E, nloc = solver.op.cells_u.shape
    n, C, dev = plans.n_rows, solver.space.dim, plans.gather.device
    recs = []
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(11)
        F_e = torch.randn((nloc, E, nloc, B), generator=gen, device=dev, dtype=dtype)
        u = torch.randn((n, C, B), generator=gen, device=dev, dtype=dtype)
        stacked = oh.onehot_gather(plans, torch.cat([u, u, u], dim=1).reshape(n, -1))
        x_e = stacked.view(E, nloc, 3 * C, B)[:, :, C:2 * C]
        s, peak = F_e.element_size(), F64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
        f_bytes, y_bytes = F_e.numel() * s, E * nloc * C * B * s
        ops = 2 * F_e.numel() * C
        modes = {
            "node rows": (lambda: oh.member_product(F_e, u, plans),
                          lambda: oh.member_product_plain(F_e, oh.onehot_gather(plans, u.reshape(n, -1)).view(
                              E, nloc, C, B)),
                          f_bytes + y_bytes + u.numel() * s + plans.gather.numel() * 8),
            "element view": (lambda: oh.member_product(F_e, x_e),
                             lambda: oh.member_product_plain(F_e, x_e), f_bytes + 2 * y_bytes),
        }
        lib = lambda: torch.einsum("jeib,ejcb->eicb", F_e, x_e)  # noqa: E731
        for mode, (fn, plain, nbytes) in modes.items():
            label = f"member_product {str(dtype).replace('torch.', '')} {mode}"
            ref = plain()
            err = float((fn() - ref).abs().max()) / float(ref.abs().max())
            tol = 1e-13 if dtype == torch.float64 else 1e-6
            if not err <= tol:
                fail(f"{label}: the kernel misses its plain version by {err:.3e} of max |plain| (tol {tol:g})")
            t = kernel_times(fn, plain, lib, reps)
            b = bound(nbytes, ops, peak)
            r = dict(kernel="member_product", mode=mode, dtype=str(dtype).replace("torch.", ""), E=E, nloc=nloc,
                     C=C, B=B, max_rel_err=err, **t, **b)
            r["share"] = share(label, b, t["device_ms"])
            log(f"{label}: {fmt_times(t, b)}; max rel err {err:.3e}")
            recs.append(r)
        # the element pass of apply_F: kernel G then C, against D, the chain, C
        pass_ms = device_ms(lambda: oh.onehot_reduce(plans, oh.member_product(F_e, u, plans).view(E * nloc, -1)),
                            reps)
        plain_pass_ms = device_ms(lambda: oh.onehot_reduce(plans, modes["node rows"][1]().view(E * nloc, -1)), reps)
        log(f"member_product {dtype}: element pass (G + C) {pass_ms:.4f} ms on device, with D + chain + C "
            f"{plain_pass_ms:.4f} ms")
        recs[-1].update(pass_device_ms=pass_ms, plain_pass_device_ms=plain_pass_ms)
        del F_e, u, stacked, x_e
    log(f"member_product records: {json.dumps(recs)}")
    return recs


def member_product_path(solver, nus, steps: int = 2) -> None:
    """`steps` ensemble steps with `operators.apply_F` wrapped: every call
    must launch kernel G once, kernel C once and kernel D never (the
    gather fused into G); fails otherwise."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh
    from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
    from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble

    inner, calls = ops.apply_F, []
    keys = ("member_product", "slot_gather", "slot_reduce")

    def counted(*args, **kwargs):
        before = dict(oh.launch_counts)
        y = inner(*args, **kwargs)
        calls.append(tuple(oh.launch_counts[k] - before[k] for k in keys))
        return y

    ops.apply_F = counted
    try:
        oh.reset_launch_counts()
        run_ensemble(solver, nus, steps)
        torch.cuda.synchronize()
    finally:
        ops.apply_F = inner
    bad = [c for c in calls if c != (1, 0, 1)]
    log(f"member_product on the ensemble path: {len(calls)} apply_F calls in {steps} steps, launches "
        f"{dict(zip(keys, map(sum, zip(*calls))))} inside them, {dict(oh.launch_counts)} in all")
    if not calls or bad:
        fail(f"ensemble apply_F: {len(bad)} of {len(calls)} calls did not launch exactly kernel G and C "
             f"(member_product, slot_gather, slot_reduce): {bad[:3]}")


def drive_member_product(device) -> None:
    """Kernel G at the ensemble benchmark's plan (64 x 46,928 DoF), timed in
    both dtypes and its modes (`member_product_times`), then on the
    ensemble's path (`member_product_path`)."""
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver

    problem = Cylinder3DProblem(test_case=2)
    solver = NavierStokesSolver(cylinder_duct_3d(**ENSEMBLE_MESH), problem, ensemble_config("float32"),
                                device=device)
    member_product_times(solver, KERNEL_REPS)
    member_product_path(solver, sweep_nus(problem, ENSEMBLE_MEMBERS))


def imex_operator_times(solver, reps: int) -> None:
    """The IMEX path's two per-iteration operators at [n, 3]: the assembled
    K (gather, product, segmented sum) with its bound and the one PyTorch
    call of the same product (a CSR `torch.sparse.mm`), and the fine
    subset's element pass (kernels D and C)."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
    from navierstokes_project_nm4pde_tpu_torch.ops.bsr import apply_csr_scalar

    K, op, dev = solver.kcsr, solver.op, solver.device
    n, nnz = K.n_rows, K.cols.numel()
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((n, 3), generator=gen, device=dev)
    perm = K.plan.perm
    with warnings.catch_warnings():  # torch's notes that sparse CSR is in beta
        warnings.simplefilter("ignore")
        Ksp = torch.sparse_csr_tensor(K.plan.offsets, K.cols[perm], K.vals[perm, 0, 0], size=(n, n))
    y, y_lib = apply_csr_scalar(K, x), torch.sparse.mm(Ksp, x)
    err = float((y - y_lib).abs().max() / y_lib.abs().max())
    t = dict(ms=time_ms(lambda: apply_csr_scalar(K, x), reps),
             library_ms=time_ms(lambda: torch.sparse.mm(Ksp, x), reps),
             device_ms=device_ms(lambda: apply_csr_scalar(K, x), reps),
             lib_device_ms=device_ms(lambda: torch.sparse.mm(Ksp, x), reps))
    # values, column ids and the sum order read once, row offsets, x, y
    b = bound(nnz * (4 + 8 + 8) + (n + 1) * 8 * 2 + 2 * x.numel() * 4, 2.0 * nnz * 3)
    log(f"K CSR apply at [{n}, 3], {nnz} entries: call {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms; "
        f"torch.sparse.mm call {t['library_ms']:.4f} ms, device {t['lib_device_ms']:.4f} ms "
        f"(max rel difference {err:.3e}); bound {b['bound_ms']:.4f} ms by {b['bound_by']}: "
        f"{share('K CSR apply', b, t['device_ms']):.1%} of bound on device")
    if solver.imex is not None:
        from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

        im = solver.imex
        w_e = ops.gather_u(op, torch.randn((n, 3), generator=gen, device=dev))
        C_ef = ops.convection_fine_fold(op, im, w_e[im.f_idx])
        u_ef = oh.onehot_gather(im.plans, x).view(C_ef.shape[0], -1, 3)
        # its gather and reduce (kernels D and C) are timed on this plan by
        # add_slot_shapes
        parts = {
            "all": lambda: ops.apply_convection_fine(im, C_ef, x),
            "element product (element_apply)": lambda: ops.element_apply(C_ef, u_ef),
            "the same as one batched GEMM (einsum)": lambda: torch.einsum("eij,ejc->eic", C_ef, u_ef),
        }
        log(f"IMEX fine-subset pass at [{n}, 3], {im.f_idx.numel()} cells, call / device ms: " + "; ".join(
            f"{k} {time_ms(f, reps):.4f} / {device_ms(f, reps):.4f}" for k, f in parts.items()))


def split_build_times(solver, reps: int) -> None:
    """The step's velocity-block build on the macro path with the K/C split
    off and on, in turns (off, on, on, off), at the solver's plan: the
    fold of F_e and kernel B, against the fold of C_e alone, kernel B and
    the in-place sum with the setup-time mass and stiffness blocks.  Logs
    call and device ms, the device bytes each allocates at its peak, and
    fails if the two disagree."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops

    op, mp, dev = solver.op, solver.macro, solver.device
    nu, dt = solver.problem.nu, solver.config.time.dt
    w = torch.randn((solver.space.n_unodes, solver.space.dim),
                    generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    w_e = ops.gather_u(op, w)

    def build(split: bool):
        conv = ops.convection_setup(op, w, fold=(nu, dt), w_e=w_e, with_diag=False, conv_only=split)
        FtT = mb.build_macro_values(mp, conv.F_e)
        if split:
            FtT.add_(solver.macro_mass, alpha=1.0 / dt).add_(solver.macro_stiff, alpha=nu)
        return FtT

    ref = build(False)
    err = float((build(True) - ref).abs().max() / ref.abs().max())
    del ref
    if not err <= KERNELS["macro_build"][2]:
        fail(f"K/C split: the split build disagrees with the full one: rel err {err:.3e}")
    rows = []
    for split in (False, True, True, False):
        free_card()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        build(split)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        f = lambda: build(split)  # noqa: E731
        rows.append((split, time_ms(f, reps), device_ms(f, reps), peak))
    log("K/C split, the step's block build in turns (call ms, device ms, peak bytes it allocates): "
        + "; ".join(f"{'on' if s else 'off'} {c:.4f} / {d:.4f} / {p / 2**20:.1f} MiB"
                    for s, c, d, p in rows)
        + f"; max rel difference {err:.3e}")


def count_syncs(solver, state, steps: int):
    """Host synchronisations in `steps` calls of `solver.step` (torch's
    sync debug mode warns at each synchronising CUDA call); returns (state,
    syncs, outer iterations of those steps)."""
    import torch

    iters = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                state, dg = solver.step(state)
                iters += int(dg["iters"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return state, sum("called a synchronizing" in str(w.message) for w in caught), iters


def launches_of(counts: dict, names, dtype: str, path: str) -> dict:
    """The launches of kernels `names` through their `dtype` entry points
    (counted under the kernel's name in float32, with `_f64` in float64),
    keyed by kernel; in float64, fails if a float32 entry point launched
    (a cast on the path)."""
    if dtype == "float64" and any(counts[k] for k in names):
        fail(f"{path}: a float64 run launched float32 entry points ({counts})")
    return {k: counts[k if dtype == "float32" else f"{k}_f64"] for k in names}


def drive_cylinder_cli(device, dim: int = 3, warmup: int = CLI_WARMUP, timed: int = CLI_TIMED,
                       dtype: str = "float32"):
    """The cylinder<dim>d entry point at its defaults (with `--dtype
    float64` when asked) through the CLI's `main`: warmup + timed steps in
    chunks of CLI_CHUNK into a temporary directory, kernel C's and D's
    counts set to 0 just before and read just after (in float64, the
    launches of their float64 entry points).  A step's time is its chunk's
    wall time over the chunk's steps and the set-up time is the first row's
    `time prec`, as the CLI logs them in forces_results_<dim>D_2case.csv;
    iterations come from gmres.csv, the pressure difference from the line
    the CLI prints.  Fails unless the CLI's files exist and the timed steps'
    forces and the pressure difference are finite and under maxiter, or if
    C or D never launched.  Returns (launches, each CSV file's header and
    column counts)."""
    import csv
    import io
    import os
    import re
    import tempfile

    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch import cli
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    n, name = warmup + timed, f"cylinder{dim}d"
    forces_csv = f"forces_results_{dim}D_2case.csv"
    flags = [] if dtype == "float32" else ["--dtype", dtype]
    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.reset_peak_memory_stats(device)
        oh.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main([name, "--n-steps", str(n), "--steps-per-chunk", str(CLI_CHUNK), *flags,
                           "--output-dir", out])
        wall = time.perf_counter() - t0
        launches = launches_of(oh.launch_counts, ("slot_reduce", "slot_gather"), dtype, f"{name} CLI")
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        files = sorted(os.listdir(out))
        for f in ("gmres.csv", "coeff_2.csv", forces_csv, "final.npz"):
            if f not in files:
                fail(f"{name} CLI: no {f} in its output ({files})")
        heads = {}  # each CSV file's header (None: a file without one) and columns
        for f in files:
            if f.endswith(".csv"):
                with open(os.path.join(out, f)) as fh:
                    rows = list(csv.reader(fh))
                named = rows and not rows[0][0].replace(".", "", 1).replace("-", "", 1).strip().isdigit()
                heads[f] = (",".join(rows[0]) if named else None, sorted({len(r) for r in rows}))
        with open(os.path.join(out, "gmres.csv")) as f:
            iters = np.array([int(r[2]) for r in csv.reader(f)])
        with open(os.path.join(out, forces_csv)) as f:
            forces = np.array([[float(v) for v in r] for r in list(csv.reader(f))[1:]])
        with np.load(os.path.join(out, "final.npz")) as z:
            final_step, final_u = int(z["step"]), z["u"]
    m = re.search(r"Pressure difference \(P\(A\) - P\(B\)\) = (\S+)", printed.getvalue())
    delta_p = float(m.group(1)) if m else float("nan")
    if rc != 0 or len(iters) != n or forces.shape[0] != n or final_step != n:
        fail(f"{name} CLI: exit {rc}, {len(iters)} gmres rows, {forces.shape[0]} force rows, "
             f"final step {final_step}, for {n} steps")
    if not (np.all(np.isfinite(forces[:, :5])) and np.all(np.isfinite(final_u)) and np.isfinite(delta_p)):
        fail(f"{name} CLI: non-finite forces, pressure difference ({delta_p}) or final u")
    if final_u.dtype != np.dtype(dtype):
        fail(f"{name} CLI: final.npz holds {final_u.dtype}, not {dtype}")
    maxit = cylinder3d_config().solver.maxiter  # the CLI's default, both dims
    timed_it = iters[warmup:]
    if np.any(timed_it >= maxit):
        fail(f"{name} CLI: a timed step reached maxiter={maxit}: {timed_it.tolist()}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{name} CLI: the path never launched kernel {k}")
    step_ms = 1e3 * forces[warmup:, 6]
    q = np.percentile(step_ms, [25, 50, 75])
    log(f"{name} CLI (its defaults, {dtype}): {n} steps in chunks of {CLI_CHUNK}, "
        f"{wall:.2f} s in main; set-up {forces[0, 5]:.2f} s; timed {timed} steps: "
        f"{1e3 * timed / step_ms.sum():.4f} steps/s, per step median {q[1]:.4f} ms, "
        f"quartiles {q[0]:.4f} / {q[2]:.4f} ms (a chunk's wall time over its steps); "
        f"peak device memory {peak:.3f} GiB")
    log(f"  outer FGMRES iterations per step {iters.tolist()} (timed mean {timed_it.mean():.2f})")
    log(f"  last step: c_d {forces[-1, 3]:.8g}, c_l {forces[-1, 4]:.8g}, delta_p {delta_p:.8g}")
    log(f"  kernel launches ({dtype}) over the {n} steps and the set-up: {launches}; per step "
        + ", ".join(f"{k} {v / n:.2f}" for k, v in launches.items()))
    return launches, heads


def read_convergence(out: str):
    """(h, eL2, eH1) columns of a convergence CLI's convergence.csv."""
    import csv
    import os

    import numpy as np

    with open(os.path.join(out, "convergence.csv")) as f:
        rows = np.array([[float(v) for v in r] for r in list(csv.reader(f))[1:]])
    return rows[:, 0], rows[:, 1], rows[:, 2]


def drive_convergence_cli(device) -> dict:
    """The convergence entry point at its defaults (levels 2 4 8 16) through
    the CLI's `main` on the card, at float32 and at --dtype float64 (the
    README's command), kernel C's and D's counts set to 0 just before each
    and read just after (in float64, the launches of their float64 entry
    points); then the same CLI on the CPU at float64 on CONV_CPU_LEVELS.
    Fails unless each card run's last-pair rates exceed CONV_MIN_RATES and
    its errors at CONV_CPU_LEVELS lie within CONV_RTOL (float32) or
    CONV_RTOL64 (float64) of the CPU's, or if C or D never launched.
    Returns the launches by dtype."""
    import tempfile

    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch import cli
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    runs = {}
    for dtype in ("float32", "float64"):
        with tempfile.TemporaryDirectory() as out:
            torch.cuda.reset_peak_memory_stats(device)
            oh.reset_launch_counts()
            t0 = time.perf_counter()
            flags = [] if dtype == "float32" else ["--dtype", dtype]
            rc = cli.main(["convergence", *flags, "--output-dir", out])
            wall = time.perf_counter() - t0
            launches = launches_of(oh.launch_counts, ("slot_reduce", "slot_gather"), dtype, "convergence CLI")
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            runs[dtype] = (rc, wall, launches, peak, *read_convergence(out))
    with tempfile.TemporaryDirectory() as ref_out:
        t0 = time.perf_counter()
        cli.main(["convergence", "--levels", *map(str, CONV_CPU_LEVELS), "--dtype", "float64",
                  "--device", "cpu", "--output-dir", ref_out])
        cpu_wall = time.perf_counter() - t0
        _, l2_ref, h1_ref = read_convergence(ref_out)
    log(f"  the CPU float64 run of levels {list(CONV_CPU_LEVELS)} ({cpu_wall:.2f} s): "
        f"L2 {l2_ref.tolist()}, H1 {h1_ref.tolist()}")
    out = {}
    for dtype, tol in (("float32", CONV_RTOL), ("float64", CONV_RTOL64)):
        rc, wall, launches, peak, h, l2, h1 = runs[dtype]
        rates = {k: np.log(e[:-1] / e[1:]) / np.log(h[:-1] / h[1:]) for k, e in (("L2", l2), ("H1", h1))}
        k = len(CONV_CPU_LEVELS)
        errs = np.abs(np.concatenate([l2[:k] / l2_ref - 1, h1[:k] / h1_ref - 1]))
        log(f"convergence CLI (its defaults, {dtype}, levels {[round(2 / x) for x in h]}): exit {rc}, "
            f"{wall:.2f} s in main, peak device memory {peak:.3f} GiB; L2 {l2.tolist()}, "
            f"H1 {h1.tolist()}; rates L2 {np.round(rates['L2'], 4).tolist()}, "
            f"H1 {np.round(rates['H1'], 4).tolist()}; kernel launches ({dtype}) {launches}; max relative "
            f"difference from the CPU float64 run {errs.max():.3e} (limit {tol:g})")
        if rc != 0 or len(h) != 4 or not np.all(np.isfinite(np.concatenate([l2, h1]))):
            fail(f"convergence CLI, {dtype}: exit {rc}, {len(h)} levels, L2 {l2}, H1 {h1}")
        for name, lo in CONV_MIN_RATES.items():
            if not rates[name][-1] > lo:
                fail(f"convergence CLI, {dtype}: the last pair's {name} rate {rates[name][-1]:.4f} "
                     f"is not above {lo}")
        if not errs.max() <= tol:
            fail(f"convergence CLI, {dtype}: errors differ from the CPU float64 run by {errs.max():.3e} > {tol:g}")
        for name, v in launches.items():
            if v <= 0:
                fail(f"convergence CLI, {dtype}: the path never launched kernel {name}")
        out[dtype] = launches
    return out


def drive_cylinder2d(device, rec: dict) -> dict:
    """The 2D paths: the cylinder2d CLI at its defaults (C and D on its
    plan), then `--fast` on the 118,071-DoF channel under bdf1 and bdf2
    (A at 2 channels and B at 6 local nodes on its macro plan, then
    FAST_2D_WARMUP + FAST_2D_TIMED steps each through the solver's run).
    Returns the launches of each path."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch import cli
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_channel_2d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder2DProblem, NavierStokesSolver

    out = {}
    t0 = time.perf_counter()
    out["cylinder2d CLI"] = drive_cylinder_cli(device, 2, CLI_2D_WARMUP, CLI_2D_TIMED)[0]
    dsolver = NavierStokesSolver(
        cylinder_channel_2d(**CLI_2D_MESH), Cylinder2DProblem(test_case=2),
        cli._build_config(cli._parser().parse_args(["cylinder2d"]), None), device=device,
    )
    add_slot_shapes(rec, "cylinder2d defaults", dsolver.op.onehot, KERNEL_REPS)
    del dsolver
    log(f"cylinder2d defaults: {time.perf_counter() - t0:.1f} s")
    mesh = cylinder_channel_2d(**FAST_2D_MESH)
    for scheme, wide in (("bdf1", None), ("bdf2", None), ("bdf1", "U=256")):
        t0 = time.perf_counter()
        cfg = cli._build_config(cli._parser().parse_args(["cylinder2d", "--fast", "--scheme", scheme]), None)
        path = f"cylinder2d --fast {scheme}" + (f", macro {wide}" if wide else "")
        if wide:
            cfg = with_changes(cfg, wide_changes(wide))
        fsolver = NavierStokesSolver(mesh, Cylinder2DProblem(test_case=2), cfg, device=device)
        mp = fsolver.macro
        torch.cuda.synchronize()
        log(f"{path}: {mesh.n_cells} cells, {fsolver.space.n_dofs} DoF; macro "
            f"B={mp.B} U={mp.U} c_blk={mp.c_blk}; host setup {time.perf_counter() - t0:.2f} s")
        if scheme == "bdf1":
            add_macro_shapes(rec, path.replace(" bdf1", ""), fsolver, (2,), KERNEL_REPS)
        _, _, _, launches = drive_single(
            path, fsolver, FAST_2D_WARMUP, FAST_2D_TIMED, ("macro_build", "macro_matvec"),
        )
        out[path] = launches
        del fsolver
        free_card()
        log(f"{path}: {time.perf_counter() - t0:.1f} s")
    return out


def monolithic_operator_times(solver, rec: dict, reps: int) -> None:
    """The monolithic step's operations at the solver's size: kernels C and
    D on its plan (checked, with bound and share), the per-step Schur ELL
    assembly and the Schur ELL SpMV (device ms with bound and share), and
    device ms of the composites: `coarse_factor`, one fixed GMRES(6) F
    solve, and one full yosida `apply_precond` of the CLI's defaults."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
    from navierstokes_project_nm4pde_tpu_torch.ops.coarse import coarse_factor
    from navierstokes_project_nm4pde_tpu_torch.ops.schur_ell import (
        assemble_schur_values,
        schur_ell_matvec,
    )
    from navierstokes_project_nm4pde_tpu_torch.precond import blocks

    op, dev, pc = solver.op, solver.device, solver.config.precond
    nu, dt = solver.problem.nu, solver.config.time.dt
    n, n_p = solver.space.n_unodes, solver.space.n_pnodes
    gen = torch.Generator(device=dev).manual_seed(6)
    w = torch.randn((n, 3), generator=gen, device=dev)
    v_u, v_p = torch.randn((n, 3), generator=gen, device=dev), torch.randn(n_p, generator=gen, device=dev)
    conv = ops.convection_setup(op, w, fold=(nu, dt))
    pst = blocks.build_precond_state(op, nu, dt, conv, pc.kind, s_solver=pc.s_solver,
                                     f_solver=pc.f_solver, f_lam=solver._f_lam0)
    add_slot_shapes(rec, "monolithic 142k", op.onehot, reps)

    s = op.schur
    T, n_slots = s.prod_vals.numel(), s.mirror.numel()
    n_pad = sum(c.numel() for c in s.cols)
    vals = pst.schur_vals
    rows = {
        # products, their node ids, inv (read once), the run lengths, the
        # mirror, the values written; a multiply and an add a product
        "Schur ELL assembly": (lambda: assemble_schur_values(s, pst.schur_inv),
                               bound(T * (4 + 8) + n * 4 + n_slots * (8 + 8 + 4), 2.0 * T)),
        # values, mask and column ids of every padded slot, the row order,
        # p read and y written; a mask product, a product and an add a slot
        "Schur ELL SpMV": (lambda: schur_ell_matvec(s, vals, v_p),
                           bound(n_pad * (4 + 4 + 8) + n_p * 8 + 2 * n_p * 4, 3.0 * n_pad)),
    }
    for name, (f, b) in rows.items():
        t_call, t_dev = time_ms(f, reps), device_ms(f, reps)
        log(f"{name} at {n_p} pressure rows, {T} products, {n_slots} slots ({n_pad} padded): "
            f"call {t_call:.4f} ms, device {t_dev:.4f} ms; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']}: {share(name, b, t_dev):.1%} of bound on device")
    # The device's launch queue holds about a thousand launches behind a
    # spin: a fixed solve (a few hundred) is timed one call at a time.  A
    # yosida application (more than the queue holds) is timed whole as a
    # CUDA graph, and by the sum of its parts' device times (two F solves,
    # the S solve, D and D^T; the sum leaves out the glue between them).
    y_p = v_p - ops.apply_divergence(op, v_u)
    parts = {
        "F solve": (2, lambda: blocks._solve_F(op, pst, nu, dt, v_u, pc)),
        "S solve": (1, lambda: blocks._solve_S(op, pst, y_p, pc)),
        "D": (1, lambda: ops.apply_divergence(op, v_u)),
        "D^T": (1, lambda: blocks._dt_apply(op, v_p)),
    }
    part_ms = {k: (m, device_ms(f, 1)) for k, (m, f) in parts.items()}
    log("monolithic composites, call / device ms: " + "; ".join(
        f"{k} {time_ms(f, reps):.4f} / {d:.4f}" for k, f, d in (
            (f"coarse_factor (nc={op.coarse.nc})", lambda: coarse_factor(op.coarse, vals),
             device_ms(lambda: coarse_factor(op.coarse, vals), reps)),
            (f"one fixed GMRES({pc.f_iters}) F solve", parts["F solve"][1], part_ms["F solve"][1]),
        )))
    app = lambda: blocks.apply_precond(pc.kind, pc, op, pst, nu, dt, v_u, v_p)  # noqa: E731
    call, whole = time_ms(app, reps), graph_device_ms(app, reps)
    log(f"{pc.kind} apply_precond (f_iters {pc.f_iters}, {pc.s_solver} {pc.s_iters}): call "
        f"{call:.4f} ms (events around eager calls from an idle queue: host-bound); device "
        + ("not measured (the capture failed)" if whole is None else
           f"{whole:.4f} ms (the whole application as one CUDA graph, its replays queued "
           f"behind a spin), {whole / call:.1%} of the eager call time")
        + "; sum of parts " + " + ".join(f"{m} x {k} {t:.4f}" for k, (m, t) in part_ms.items())
        + f" = {sum(m * t for m, t in part_ms.values()):.4f} ms")


def drive_ensemble_cli(device, rec: dict) -> dict:
    """The ensemble entry point at its defaults through the CLI's `main`
    (the monolithic stepper, asimple, 64 members of 32,536 DoF, float32):
    ENSEMBLE_CLI_STEPS steps in chunks of ENSEMBLE_CLI_CHUNK into a temporary
    directory, kernel C's and D's counts set to 0 just before and read just
    after.  `run_ensemble` is wrapped to keep its solver and diagnostics
    (outer iterations per member and step), and its member-steps/s after
    the first chunk are read from its stderr line.  Then C and D on that
    plan.  Fails unless ensemble.csv holds every member's finite row, or if
    every step of a member reached maxiter, or C or D never launched."""
    import csv
    import io
    import os
    import re
    import tempfile

    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch import cli
    from navierstokes_project_nm4pde_tpu_torch import parallel as par
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    seen, orig = {}, par.run_ensemble

    def recording(solver, nus, n_steps, state=None):
        out = orig(solver, nus, n_steps, state)
        seen.update(solver=solver, state=out[0], diags=out[1])
        return out

    err = io.StringIO()
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.reset_peak_memory_stats(device)
        oh.reset_launch_counts()
        par.run_ensemble = recording
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err):
                rc = cli.main(["ensemble", "--n-steps", str(ENSEMBLE_CLI_STEPS), "--steps-per-chunk",
                               str(ENSEMBLE_CLI_CHUNK), "--output-dir", out])
        finally:
            par.run_ensemble = orig
        wall = time.perf_counter() - t0
        launches = launches_of(oh.launch_counts, ("slot_reduce", "slot_gather"), "float32", "ensemble CLI")
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        with open(os.path.join(out, "ensemble.csv")) as f:
            rows = np.array([[float(v) for v in r] for r in list(csv.reader(f))[1:]])
    solver, d = seen["solver"], seen["diags"]
    B = d.iters_f.shape[0]
    m = re.search(r"sustained ([0-9.]+) member-steps/s", err.getvalue())
    rate = float(m.group(1)) if m else float("nan")
    log(f"ensemble CLI (its defaults: {solver.config.time.stepper}, {solver.config.precond.kind}, "
        f"float32): {B} members x {solver.space.n_dofs} DoF, {ENSEMBLE_CLI_STEPS} steps in chunks of "
        f"{ENSEMBLE_CLI_CHUNK}, exit {rc}, {wall:.2f} s in main; {rate} member-steps/s after the first "
        f"chunk (run_ensemble's reading); peak device memory {peak:.3f} GiB")
    log(f"  outer FGMRES iterations per member and step: max {d.iters_f.max()}, mean "
        f"{d.iters_f.mean():.3f}; per step mean {np.round(d.iters_f.mean(axis=0), 2).tolist()}, "
        f"max {d.iters_f.max(axis=0).tolist()}; Re 20 member {d.iters_f[0].tolist()}, Re 300 member "
        f"{d.iters_f[-1].tolist()}")
    log(f"  kernel launches over the {ENSEMBLE_CLI_STEPS} steps and the set-up: {launches}")
    if rc != 0 or rows.shape != (B, 5) or not np.all(np.isfinite(rows)) or rows[0, 0] != 20.0 \
            or rows[-1, 0] != 300.0:
        fail(f"ensemble CLI: exit {rc}, ensemble.csv rows {rows.shape}, finite {np.all(np.isfinite(rows))}")
    check_run("ensemble CLI", solver, seen["state"], d, launches, any_maxiter=False)
    if np.any(np.all(d.iters_f >= solver.config.solver.maxiter, axis=1)):
        fail("ensemble CLI: every step of a member reached maxiter")
    add_slot_shapes(rec, "ensemble CLI defaults", solver.op.onehot, KERNEL_REPS)
    return launches


def _small_config(conf: str):
    """The small checks' configuration `conf` as a function of the dtype:
    "bench", "ensemble", "cylinder3d" (the CLI's defaults), "asimple"."""
    return {
        "bench": bench_config, "ensemble": ensemble_config, "cylinder3d": cylinder3d_config,
        "asimple": functools.partial(cylinder3d_config, kind="asimple"),
    }[conf]


def check_small_f64(device) -> None:
    """F64_CHECKS, card float64 against CPU float64 on the small duct (the
    same counts, u and p within F64_RTOL), each path's kernels launched in
    float64 on the card; then the CPU float64 state after F64_CARRY_STEPS
    steps, written to a checkpoint and loaded on the card at float64,
    continues there as on the CPU."""
    import os
    import tempfile

    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    for name, (conf, changes) in F64_CHECKS.items():
        mb.reset_launch_counts()
        oh.reset_launch_counts()
        if conf == "ensemble":
            check_small_ensemble(device, f"float64, {name}", ensemble_config, changes, F64_RTOL, "float64")
        else:
            check_small_duct(device, f"float64, {name}", changes, config=_small_config(conf), rtol=F64_RTOL,
                             card_dtype="float64")
        counts = launches_of({**mb.launch_counts, **oh.launch_counts}, ("macro_build", "macro_matvec")
                             if conf == "bench" else ("slot_reduce", "slot_gather"), "float64", name)
        log(f"  float64 kernel launches on the card: {counts}")
        if not all(v > 0 for v in counts.values()):
            fail(f"float64, {name}: a kernel of the path never launched in float64 ({counts})")

    mesh, problem, cfg = cylinder_duct_3d(**SMALL_DUCT), Cylinder3DProblem(test_case=2), bench_config("float64")
    cpu = NavierStokesSolver(mesh, problem, cfg, device="cpu")
    st, _ = cpu.run(F64_CARRY_STEPS)
    rest = AGREE_STEPS - F64_CARRY_STEPS
    ref, dref = cpu.run(rest, state=st)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "carry.npz")
        save_checkpoint(path, st)
        carried = load_checkpoint(path, dtype=torch.float64, device=device)
    out, dout = NavierStokesSolver(mesh, problem, cfg, device=device).run(rest, state=carried)
    errs = small_errors({k: getattr(out, k).cpu().numpy() for k in ("u", "p")},
                        {k: getattr(ref, k).numpy() for k in ("u", "p")})
    log(f"float64 carry-over: the CPU state after {F64_CARRY_STEPS} steps, through a checkpoint, {rest} steps on "
        f"the card ({carried.u.dtype} on {carried.u.device}): F iters {dout.iters_f.tolist()} (cpu "
        f"{dref.iters_f.tolist()}), S {dout.iters_s.tolist()} (cpu {dref.iters_s.tolist()}); "
        + ", ".join(f"{k} err {v:.3e}" for k, v in errs.items()))
    if not (np.array_equal(dout.iters_f, dref.iters_f) and np.array_equal(dout.iters_s, dref.iters_s)
            and all(v <= F64_RTOL for v in errs.values())):
        fail(f"float64 carry-over: the card's continuation differs from the CPU's ({errs})")


def check_small_unfolded(device) -> None:
    """UNFOLDED_CHECKS: fold_elem=False and spatial_reorder=False on the
    small duct, card float32 against CPU float64."""
    for name, (conf, changes, rtol) in UNFOLDED_CHECKS.items():
        check_small_duct(device, name, changes, config=_small_config(conf), rtol=rtol)


def check_small_ensembles(device) -> None:
    """ENSEMBLE_VARIANT_CHECKS: each variant's ensemble, card against CPU."""
    for name, (conf, changes, rtol) in ENSEMBLE_VARIANT_CHECKS.items():
        config = ensemble_config if conf == "ensemble" else functools.partial(cylinder3d_config, **conf[1])
        check_small_ensemble(device, name, config, changes, rtol)


def halo_config(dtype: str = "float32"):
    """__graft_entry__.py:149-159's owned+halo configuration (the projection
    stack, guess_order 2, s_recycle 4), at `dtype`."""
    from navierstokes_project_nm4pde_tpu_torch.config import (
        NumericsConfig,
        PrecondConfig,
        RunConfig,
        SolverConfig,
        TimeConfig,
    )

    return RunConfig(
        time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-5, restart=8, maxiter=40, tol_mode="b", guess_order=2),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3, mg2_form="additive", s_recycle=4),
        numerics=NumericsConfig(dtype=dtype, precise_dots=False, steps_per_chunk=1, reduce_plan="columns",
                                proj_schur="frozen", schur_spmv="auto"),
    )


def _halo_rank(rank, world, device, steps: int, mesh_kw: dict) -> dict:
    """Every rank of the halo phase: the owned+halo projection step on
    cylinder_duct_3d(**mesh_kw), `steps` steps from rest, each timed to a device
    synchronise; returns the counts, ms, bytes sent, its kernel launches,
    and on rank 0 the natural-order u and p."""
    import torch
    import torch.distributed as dist

    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh
    from navierstokes_project_nm4pde_tpu_torch.parallel import make_device_mesh
    from navierstokes_project_nm4pde_tpu_torch.parallel.halo import collective_bytes_per_apply
    from navierstokes_project_nm4pde_tpu_torch.parallel.halo_step import HaloProjectionStep

    t0 = time.perf_counter()
    solver = NavierStokesSolver(cylinder_duct_3d(**mesh_kw), Cylinder3DProblem(test_case=2), halo_config(),
                                device=device)
    group = make_device_mesh()
    hs = HaloProjectionStep(solver, group)
    st = hs.init_state()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    oh.reset_launch_counts()
    iters, ms, sent = [], [], []
    for _ in range(steps):
        b0, t0 = hs.ex_u.bytes_sent, time.perf_counter()
        st, it = hs(st)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        iters.append(it)
        sent.append(hs.ex_u.bytes_sent - b0)
    launches = dict(oh.launch_counts)
    u = hs.unshard(st.u)
    return dict(
        iters=iters, ms=ms, bytes=sent, launches=launches, setup_s=setup_s, backend=dist.get_backend(group),
        n_loc=hs.plan.u.n_loc, n_ext=hs.plan.u.n_ext, halo_sizes=hs.plan.u.halo_sizes,
        per_apply=collective_bytes_per_apply(hs.plan, solver.space.dim, itemsize=4),
        u=u.cpu().numpy() if rank == 0 else None, p=st.p.cpu().numpy() if rank == 0 else None,
    )


def check_ranks(path: str, kernels=("slot_reduce", "slot_gather")) -> list:
    """The last launch's ranks: fail if one imported jax or the JAX package,
    or launched one of `kernels` no time.  Returns the ranks' results."""
    from navierstokes_project_nm4pde_tpu_torch.parallel.launch import last_launch

    for r, mods in enumerate(last_launch["modules"]):
        bad = sorted(set(mods) & set(FORBIDDEN_MODULES))
        if bad:
            fail(f"{path}: rank {r} imported {bad}")
    for r, res in enumerate(last_launch["results"]):
        counts = res.get("kernel_launches", res.get("launches", {}))
        for k in kernels:
            if counts.get(k, 0) <= 0:
                fail(f"{path}: rank {r} never launched kernel {k} ({counts})")
    return last_launch["results"]


def drive_multi_device(device, rec: dict) -> dict:
    """Multi-device runs on the one card, local ranks under torch.distributed
    (gloo: both ranks share the card): `cylinder3d --shard-cells 2` at the
    CLI's defaults against the unsharded run on the card (F counts within
    SHARD_ITERS_SLACK a step, u and p within twice the monolithic float32
    tolerance); the owned+halo projection step on 2 ranks (counts, ms a step,
    the backend and the bytes exchanged a step against
    `collective_bytes_per_apply`) against the single-device step; and
    `ensemble --shard-batch`.  Each rank's kernel counts are its own, from 0
    in its fresh interpreter.  Returns the launches by path (rank 0's)."""
    import csv
    import os
    import tempfile

    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch import cli
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
    from navierstokes_project_nm4pde_tpu_torch.ops.onehot import build_onehot_plans
    from navierstokes_project_nm4pde_tpu_torch.parallel import launch
    from navierstokes_project_nm4pde_tpu_torch.parallel.halo import build_halo_plan
    from navierstokes_project_nm4pde_tpu_torch.parallel.launch import backend_for
    from navierstokes_project_nm4pde_tpu_torch.parallel.sharding import _pad_cells

    out_paths = {}
    mesh = cylinder_duct_3d(**CLI_MESH)
    n = SHARD_WARMUP + SHARD_TIMED
    # ---- cylinder3d --shard-cells 2 at its defaults
    log(f"multi-device: {SHARD_RANKS} local ranks on {torch.cuda.device_count()} card(s), backend "
        f"{backend_for('cuda', SHARD_RANKS)}")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = cli.main(["cylinder3d", "--shard-cells", str(SHARD_RANKS), "--n-steps", str(n),
                       "--steps-per-chunk", str(CLI_CHUNK), "--output-dir", out])
        wall = time.perf_counter() - t0
        res = check_ranks("cylinder3d --shard-cells")
        with open(os.path.join(out, "gmres.csv")) as f:
            iters = np.array([int(r[2]) for r in csv.reader(f)])
        with open(os.path.join(out, "forces_results_3D_2case.csv")) as f:
            forces = np.array([[float(v) for v in r] for r in list(csv.reader(f))[1:]])
        with np.load(os.path.join(out, "final.npz")) as z:
            u_sh, p_sh = z["u"], z["p"]
    ref_solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cylinder3d_config("float32"), device=device)
    t0 = time.perf_counter()
    st, d = ref_solver.run(n)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    step_ms = 1e3 * forces[SHARD_WARMUP:, 6]
    errs = small_errors({"u": u_sh, "p": p_sh}, {"u": st.u.double().cpu().numpy(), "p": st.p.double().cpu().numpy()})
    log(f"cylinder3d --shard-cells {SHARD_RANKS} (its defaults, float32, {ref_solver.space.n_dofs} DoF): exit "
        f"{rc}, {wall:.2f} s in main (the ranks' spawn and set-up included); set-up {forces[0, 5]:.2f} s; "
        f"timed {SHARD_TIMED} steps: {1e3 * SHARD_TIMED / step_ms.sum():.4f} steps/s (a chunk's wall "
        f"time over its steps); outer iterations {iters.tolist()}, unsharded on the card "
        f"{d.iters.tolist()} ({ref_wall:.2f} s for {n} steps); u err {errs['u']:.3e}, p err {errs['p']:.3e} "
        f"of max |ref|; rank kernel launches {[r['kernel_launches'] for r in res]}")
    tol = 2 * MONO_CHECKS["cylinder3d defaults (yosida)"][1]
    if rc != 0 or len(iters) != n or np.any(np.abs(iters - d.iters) > SHARD_ITERS_SLACK):
        fail(f"cylinder3d --shard-cells: exit {rc}, iterations {iters.tolist()} against {d.iters.tolist()}")
    if not (errs["u"] <= tol and errs["p"] <= tol):
        fail(f"cylinder3d --shard-cells: u err {errs['u']:.3e}, p err {errs['p']:.3e} > {tol:g} of max |ref|")
    out_paths["cylinder3d --shard-cells (rank 0)"] = res[0]["kernel_launches"]
    pad = _pad_cells(ref_solver.op, SHARD_RANKS)
    blk = pad.cells_u.shape[0] // SHARD_RANKS
    add_slot_shapes(rec, "sharded rank 0", build_onehot_plans(pad.cells_u[:blk].cpu().numpy(),
                                                              ref_solver.space.n_unodes, device=device),
                    KERNEL_REPS)
    plan = build_halo_plan(pad, SHARD_RANKS, n_vertices=ref_solver.mesh.n_vertices)
    add_slot_shapes(rec, "halo rank 0", build_onehot_plans(plan.u.cells_loc[0], plan.u.n_ext, device=device),
                    KERNEL_REPS)
    del ref_solver, st, pad, plan
    free_card()

    # ---- the owned+halo projection step on 2 ranks
    t0 = time.perf_counter()
    res = launch(_halo_rank, SHARD_RANKS, HALO_STEPS, CLI_MESH, device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    check_ranks("halo step")
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), halo_config(), device=device)
    st, d = solver.run(HALO_STEPS)
    r0 = res[0]
    errs = small_errors({"u": r0["u"], "p": r0["p"]},
                        {"u": st.u.double().cpu().numpy(), "p": st.p.double().cpu().numpy()})
    pa = r0["per_apply"]
    log(f"halo step, {SHARD_RANKS} ranks at {solver.space.n_dofs} DoF (__graft_entry__.py's halo configuration, "
        f"float32; backend {r0['backend']}, slabs staged through host memory): {wall:.2f} s launch, rank set-up "
        f"{[round(r['setup_s'], 2) for r in res]} s; F/S per step {r0['iters']}, single device "
        f"{list(zip(d.iters_f.tolist(), d.iters_s.tolist()))}; ms per step {[round(t, 3) for t in r0['ms']]} "
        f"(rank 1 {[round(t, 3) for t in res[1]['ms']]}); u err {errs['u']:.3e}, p err {errs['p']:.3e} of "
        f"max |ref|")
    log(f"  halo: n_loc {r0['n_loc']}, n_ext {r0['n_ext']}, slabs {r0['halo_sizes']}; bytes sent a step by rank "
        f"{[r['bytes'] for r in res]}; collective_bytes_per_apply (f32): halo {pa['halo_bytes_per_device']} "
        f"B/device/apply against the replicated all-reduce {pa['replicated_allreduce_bytes_total'] // SHARD_RANKS} "
        f"B/device/apply (ratio {pa['ratio']:.4f}); rank kernel launches {[r['launches'] for r in res]}")
    for (ff, fs), f1, s1 in zip(r0["iters"], d.iters_f, d.iters_s):
        if abs(ff - f1) > SHARD_ITERS_SLACK or abs(fs - s1) > SHARD_ITERS_SLACK:
            fail(f"halo step: counts {r0['iters']} against the single device's "
                 f"{list(zip(d.iters_f.tolist(), d.iters_s.tolist()))}")
    if not all(e <= HALO_RTOL for e in errs.values()):
        fail(f"halo step: errors {errs} > {HALO_RTOL:g} of max |ref|")
    out_paths["halo step (rank 0)"] = r0["launches"]
    del solver, st
    free_card()

    # ---- ensemble --shard-batch
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = cli.main(["ensemble", "--shard-batch", "--n-members", str(SHARD_BATCH_MEMBERS), "--n-steps", "2",
                       "--steps-per-chunk", "1", "--output-dir", out])
        wall = time.perf_counter() - t0
        res = check_ranks("ensemble --shard-batch")
        with open(os.path.join(out, "ensemble.csv")) as f:
            rows = np.array([[float(v) for v in r] for r in list(csv.reader(f))[1:]])
    log(f"ensemble --shard-batch ({SHARD_BATCH_MEMBERS} members, its defaults, 2 steps): exit {rc}, "
        f"{len(res)} rank(s) (one per card, the reference's rule), {wall:.2f} s; ensemble.csv {rows.tolist()}")
    if rc != 0 or rows.shape != (SHARD_BATCH_MEMBERS, 5) or not np.all(np.isfinite(rows)):
        fail(f"ensemble --shard-batch: exit {rc}, rows {rows.shape}")
    out_paths["ensemble --shard-batch (rank 0)"] = res[0]["kernel_launches"]
    return out_paths


def wide_macro_launched(path: str, changes: dict) -> None:
    """After a float32 run under `changes`: if they set numerics.macro_u,
    fail unless kernels A and B launched since the counts were last reset."""
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    if "macro_u" not in changes.get("numerics", {}):
        return
    counts = launches_of(mb.launch_counts, ("macro_build", "macro_matvec"), "float32", path)
    log(f"  {path}: macro kernel launches on the card: {counts}")
    if not all(v > 0 for v in counts.values()):
        fail(f"{path}: a macro kernel never launched at the wide U ({counts})")


def macro_parts_ms(mp, reps: int) -> dict:
    """Device ms of the macro path's per-step block build (kernel B) and of
    one F apply at 3 channels by part: slot gather, kernel A, node reduce,
    and whole (float32, seeded inputs) on plan `mp`."""
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    dev = mp.lidx.device
    gen = torch.Generator(device=dev).manual_seed(6)
    F_e = torch.randn((mp.E, mp.lidx.shape[2], mp.lidx.shape[2]), generator=gen, device=dev)
    u = torch.randn((mp.n, 3), generator=gen, device=dev)
    FtT = mb.macro_build(F_e, mp.lidx, mp.B, mp.U)
    x_b = mb.slot_gather(mp, u)
    y_b = mb.macro_matvec(FtT, x_b)
    return dict(
        build=device_ms(lambda: mb.macro_build(F_e, mp.lidx, mp.B, mp.U), reps),
        gather=device_ms(lambda: mb.slot_gather(mp, u), reps),
        matvec=device_ms(lambda: mb.macro_matvec(FtT, x_b), reps),
        reduce=device_ms(lambda: mb.node_reduce(mp, y_b), reps),
        apply=device_ms(lambda: mb.apply_macro(mp, FtT, u), reps),
    )


def drive_wide_macro(device, rec: dict, rec64: dict, mesh=None, base=None) -> dict:
    """The single run at 965,265 DoF at each WIDE_MACRO width: its kernels
    A (3 channels) and B checked and timed on its plan (added to `rec` /
    `rec64` under "shapes", beside the bands they run in), then
    WARMUP_STEPS + TIMED_STEPS in float32 and F64_WARMUP + F64_TIMED in
    float64 through `drive_single` (a non-finite value, a timed step at
    maxiter or a macro kernel never launched fails it), each step's F and S
    beside the U = 128 run's (`base`: dtype -> its timed diagnostics).
    Then kernels A and B on the 965k plan at WIDE_PLAN_ONLY, in both dtypes,
    and `macro_parts_ms` on the plans at U = 128, each width and
    WIDE_PLAN_ONLY.  Returns each run's launches, keyed by path."""
    import types

    import torch

    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    mesh = mesh if mesh is not None else cylinder_duct_3d(lc=0.024, nz=14)
    out, parts = {}, {}
    for name in WIDE_MACRO:
        for dtype, warmup, timed in (("float32", WARMUP_STEPS, TIMED_STEPS), ("float64", F64_WARMUP, F64_TIMED)):
            path = f"single run, macro {name}, {dtype}"
            t0 = time.perf_counter()
            solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2),
                                        with_changes(bench_config(dtype), wide_changes(name)), device=device)
            solver.macro_mass  # built at first use (with the plan): this path's setup
            mp = solver.macro
            torch.cuda.synchronize()
            nloc = mp.lidx.shape[2]
            log(f"{path}: host setup {time.perf_counter() - t0:.2f} s (mesh reused); macro B={mp.B} "
                f"U={mp.U} c_blk={mp.c_blk}; kernel B in bands of {mb.band_rows(solver.dtype, mp.c_blk, nloc, mp.U)} "
                f"rows, kernel A in bands of {mb.band_cols(solver.dtype, 3, mp.U)} columns at C=3")
            add_macro_shapes(rec if dtype == "float32" else rec64, f"single run, macro {name}", solver, (3,),
                             KERNEL_REPS)
            if dtype == "float32":
                parts[mp.U] = macro_parts_ms(mp, KERNEL_REPS)
            free_card()
            keys = ("macro_build", "macro_matvec") if dtype == "float32" else ("macro_build_f64", "macro_matvec_f64")
            _, d, _, counts = drive_single(path, solver, warmup, timed, keys)
            out[path] = launches_of(counts, ("macro_build", "macro_matvec"), dtype, path)
            if base is not None and dtype in base:
                b = base[dtype]
                log(f"  {path}: F a step {d.iters_f.tolist()} (mean {d.iters_f.mean():.2f}), U=128 "
                    f"{b.iters_f.tolist()} (mean {b.iters_f.mean():.2f}); S a step {d.iters_s.tolist()} "
                    f"(mean {d.iters_s.mean():.2f}), U=128 {b.iters_s.tolist()} (mean {b.iters_s.mean():.2f})")
            cells, n_unodes = solver.space.cells_u, solver.space.n_unodes
            del solver
            free_card()
            log(f"{path}: {time.perf_counter() - t0:.1f} s")
    U, c_blk = WIDE_PLAN_ONLY
    mp = mb.build_macro_plan(cells, n_unodes, U=U, c_blk=c_blk, device=device)
    for dtype, r in ((torch.float32, rec), (torch.float64, rec64)):
        log(f"the 965k plan at U={U} ({dtype}): B={mp.B} c_blk={mp.c_blk}; kernel B in bands of "
            f"{mb.band_rows(dtype, mp.c_blk, mp.lidx.shape[2], U)} rows, kernel A in bands of "
            f"{mb.band_cols(dtype, 3, U)} columns at C=3")
        add_macro_shapes(r, f"965k plan at U={U} (no run)", types.SimpleNamespace(macro=mp, device=device, dtype=dtype),
                         (3,), KERNEL_REPS)
        free_card()
    parts[U] = macro_parts_ms(mp, KERNEL_REPS)
    del mp
    parts[128] = macro_parts_ms(mb.build_macro_plan(cells, n_unodes, device=device), KERNEL_REPS)
    free_card()
    log("the 965k macro path by part, float32 device ms (build; an F apply at C=3: slot gather, kernel A, "
        "node reduce, whole): " + "; ".join(
            f"U={U}: build {t['build']:.4f}, gather {t['gather']:.4f}, A {t['matvec']:.4f}, "
            f"reduce {t['reduce']:.4f}, apply {t['apply']:.4f}" for U, t in sorted(parts.items())))
    return out


def check_fault7(device, rec: dict, rec64: dict) -> None:
    """Kernels B and A at FAULT7's widths (Queue 3 fault 7): on each width's
    seeded slot table and F_e, B checked against its plain version and
    timed, then A at the width's channel counts on B's output
    (`add_macro_shapes`, into `rec`, or `rec64` in float64)."""
    import types

    import numpy as np
    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb

    nloc, rng = 10, np.random.default_rng(7)
    for U, c_blk, dt_name, B, widths in FAULT7:
        dtype = getattr(torch, dt_name)
        # each cell's nodes distinct slots; the last block one cell short
        lidx = torch.as_tensor(np.stack([
            np.stack([rng.choice(U, nloc, replace=False) for _ in range(c_blk)]) for _ in range(B)
        ]).astype(np.int32), device=device)
        plan = types.SimpleNamespace(lidx=lidx, B=B, U=U, c_blk=c_blk, E=B * c_blk - 1)
        label = (f"fault 7 ({dt_name}): B in tiles of {mb.band_rows(dtype, c_blk, nloc, U)} rows x "
                 f"{mb.build_band_cols(dtype, c_blk, nloc, U)} columns; A in bands of "
                 + ", ".join(f"{mb.band_cols(dtype, C, U)} columns with the panel in chunks of "
                             f"{mb.panel_rows(dtype, C, U)} rows at C={C}" for C in widths))
        log(label)
        add_macro_shapes(rec64 if dtype == torch.float64 else rec, label,
                         types.SimpleNamespace(macro=plan, device=device, dtype=dtype), widths, KERNEL_REPS)
        del lidx, plan
        free_card()


def dfg_args(mod, argv, dtype: str = "float32"):
    """(mesh, problem, config at `dtype`, steps) of a DFG module's run at
    its defaults with `argv`, built as its `main` builds it."""
    import dataclasses

    mesh, problem, cfg, n = mod.build(mod.parser().parse_args(argv))
    return mesh, problem, dataclasses.replace(cfg, numerics=dataclasses.replace(cfg.numerics, dtype=dtype)), n


def run_dfg_main(mod, argv: list, device) -> dict:
    """A DFG module's `main(argv)` on the card, kernel counts set to 0 just
    before and read just after: its JSON summary, its header line, the wall
    seconds in `main`, the launches of kernels A-D and the peak device
    memory.  Fails unless it exits 0 and prints one JSON line."""
    import io

    import torch

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats(device)
    mb.reset_launch_counts()
    oh.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main([*argv, "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = {**launches_of(mb.launch_counts, ("macro_build", "macro_matvec"), "float32", mod.__name__),
                **launches_of(oh.launch_counts, ("slot_reduce", "slot_gather"), "float32", mod.__name__)}
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        fail(f"{mod.__name__} {argv}: exit {rc}, stdout {out.getvalue()[-500:]!r}, stderr {err.getvalue()[-500:]!r}")
    return dict(summary=json.loads(lines[0]), header=err.getvalue().strip(), wall=wall, launches=launches,
                peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)


def drive_dfg(device, rec: dict, out_dir=None) -> dict:
    """The DFG validation path (`dfg`): (a) each module's run on the small
    geometry (DFG_SMALL), card float32 against CPU float64 for AGREE_STEPS
    steps (`check_small`), and each `main` on the card for
    DFG_MAIN_STEPS steps; (b) each at scale (DFG_2D_SCALE, DFG_3D_SCALE):
    warm-up + timed steps through `drive_single` (steps/s, iterations,
    peak memory, finite coefficients; kernels A and B must launch, and C
    launches once a step for diag C(w), the configuration leaving
    freeze_conv_diag off), then on the run's own plans kernels A (at the
    channel counts the timed steps launched it with) and B
    (`add_macro_shapes`; the 2D-2 plan fits the L2 cache: its shares are
    logged, not held) and C (SLOT_SHAPES) against their plain versions,
    into `rec`.  Returns each path's launches."""
    import math
    import tempfile

    import torch

    from navierstokes_project_nm4pde_tpu_torch.models import NavierStokesSolver
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.validation import dfg3d_validate, dfg_validate

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mod in (("2D-2", dfg_validate), ("3D-1Z", dfg3d_validate)):
            small, rtol = DFG_SMALL[name]
            mesh, problem, _, _ = dfg_args(mod, small)
            check_small(device, f"DFG {name}, small ({' '.join(small)})", mesh, problem,
                        lambda dtype: dfg_args(mod, small, dtype)[2], AGREE_STEPS, rtol)
            t_end = DFG_MAIN_STEPS * float(small[small.index("--dt") + 1])
            argv = [*small, "--t-end", f"{t_end:g}", "--chunk", "5", "--out-dir", out_dir or tmp]
            if mod is dfg_validate:
                argv += ["--t-measure", "0"]
            r = run_dfg_main(mod, argv, device)
            s = r["summary"]
            log(f"{mod.__name__} main on the card ({' '.join(argv)}): {r['header']}; {r['wall']:.2f} s; "
                f"launches {r['launches']}; summary {json.dumps(s)}")
            finite = [k for k, v in s.items() if isinstance(v, float) and not math.isfinite(v)]
            if finite or r["launches"]["macro_build"] <= 0 or r["launches"]["macro_matvec"] <= 0:
                fail(f"{mod.__name__} main: non-finite {finite} or a macro kernel never launched ({r['launches']})")
            paths[f"DFG {name} main, {DFG_MAIN_STEPS} steps"] = r["launches"]
    for name, mod, (argv, warmup, timed) in (("2D-2", dfg_validate, DFG_2D_SCALE),
                                             ("3D-1Z", dfg3d_validate, DFG_3D_SCALE)):
        t0 = time.perf_counter()
        mesh, problem, cfg, _ = dfg_args(mod, argv)
        solver = NavierStokesSolver(mesh, problem, cfg, device=device)
        solver.macro_mass  # built at first use (with the plan): this path's setup
        torch.cuda.synchronize()
        mp = solver.macro
        path = f"DFG {name} ({' '.join(argv)}), {solver.space.n_dofs} DoF"
        log(f"{path}: {mesh.n_cells} cells; macro B={mp.B} U={mp.U} c_blk={mp.c_blk} nloc={mp.lidx.shape[2]}; "
            f"host setup {time.perf_counter() - t0:.2f} s")
        _, _, _, launches = drive_single(path, solver, warmup, timed, ("macro_build", "macro_matvec"))
        widths = tuple(sorted(mb.matvec_channels))
        others = {k: launches[k] for k in ("slot_reduce", "slot_gather")}
        log(f"  {path}: kernels C and D in the timed steps (C: diag C(w), once a step): {others}")
        paths[path] = {k: launches[k] for k in ("macro_build", "macro_matvec", "slot_reduce", "slot_gather")}
        free_card()
        add_macro_shapes(rec, f"DFG {name} at scale", solver, widths, KERNEL_REPS, l2=True)
        add_slot_shapes(rec, f"DFG {name} at scale", solver.op.onehot, KERNEL_REPS)
        del solver
        free_card()
    return paths


def _tf32(x):
    """float32 `x` rounded to TF32's 10-bit mantissa (to nearest)."""
    import torch

    return ((x.view(torch.int32) + (1 << 12)) & -(1 << 13)).view(torch.float32)


def drive_dfg_spread(device) -> None:
    """The small DFG 2D-2 check (DFG_SMALL) DFG_SPREAD_RUNS times, each
    held to its tolerance, then once with kernel B's card output rounded to
    TF32 (`_tf32`), which fails unless it reads above the tolerance."""
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.validation import dfg_validate

    small, rtol = DFG_SMALL["2D-2"]
    mesh, problem, _, _ = dfg_args(dfg_validate, small)

    def config(dtype):
        return dfg_args(dfg_validate, small, dtype)[2]

    worst = [max(check_small(device, f"DFG 2D-2, small, run {i + 1}", mesh, problem, config, AGREE_STEPS,
                             rtol).values()) for i in range(DFG_SPREAD_RUNS)]
    build = mb.macro_build
    mb.macro_build = lambda F_e, *a: (build(F_e, *a) if F_e.device.type == "cpu" else _tf32(build(F_e, *a)))
    try:
        planted = max(check_small(device, "DFG 2D-2, small, kernel B's output rounded to TF32", mesh, problem,
                                  config, AGREE_STEPS, float("inf")).values())
    finally:
        mb.macro_build = build
    log(f"DFG 2D-2 small check, worst quantity a run: {', '.join(f'{w:.3e}' for w in worst)} "
        f"(max {max(worst):.3e}); B rounded to TF32 {planted:.3e}; tolerance {rtol:g}")
    if not planted > rtol:
        fail(f"the small DFG 2D-2 check did not see kernel B rounded to TF32: {planted:.3e} <= {rtol:g}")


def dfg_3d_deviations(rung, s: dict) -> dict:
    """How far the 3D-1Z summary `s` of a run on `rung` lies from the JAX
    package's float64 readings there (DFG_3D_JAX): c_d and delta-p
    relative, c_l and the drift absolute."""
    ref = DFG_3D_JAX[rung]
    return {"cd": abs(s["cd"] / ref["cd"] - 1), "cl": abs(s["cl"] - ref["cl"]),
            "delta_p": abs(s["delta_p"] / ref["delta_p"] - 1),
            "cd_drift_rel": abs(s["cd_drift_rel"] - ref["cd_drift_rel"])}


def drive_dfg_3d_spread(device) -> None:
    """The DFG_3D_LADDER through dfg3d_validate's `main` DFG_3D_SPREAD_RUNS
    times in float32, then once with kernel B's card output rounded to TF32
    (`_tf32`), each run's readings and `dfg_3d_deviations` logged, then each
    quantity's largest sound deviation and the TF32 run's on each rung.
    Fails if a sound run misses its limits (`dfg_3d_misses`) or the TF32 run
    meets them on a rung."""
    import tempfile

    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
    from navierstokes_project_nm4pde_tpu_torch.validation import dfg3d_validate

    def ladder(label):
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            for lc, nz in DFG_3D_LADDER:
                r = run_dfg_main(dfg3d_validate, ["--lc", str(lc), "--nz", str(nz), "--out-dir", tmp], device)
                s = runs[(lc, nz)] = r["summary"]
                log(f"dfg_3d_spread {label} lc {lc} nz {nz}: " + json.dumps(
                    {k: s[k] for k in ("dofs", "cd", "cl", "delta_p", "cd_drift_rel", "iters_per_step_warm")})
                    + "; deviation " + json.dumps(dfg_3d_deviations((lc, nz), s)))
        return runs

    sound = [ladder(f"run {i + 1}") for i in range(DFG_3D_SPREAD_RUNS)]
    build = mb.macro_build
    mb.macro_build = lambda F_e, *a: (build(F_e, *a) if F_e.device.type == "cpu" else _tf32(build(F_e, *a)))
    try:
        planted = ladder("kernel B rounded to TF32")
    finally:
        mb.macro_build = build
    misses, unseen = [], []
    for rung in DFG_3D_LADDER:
        worst = {k: max(dfg_3d_deviations(rung, run[rung])[k] for run in sound) for k in DFG_3D_JAX[rung]}
        log(f"dfg_3d_spread lc {rung[0]} nz {rung[1]}: largest sound deviation {json.dumps(worst)}; "
            f"kernel B rounded to TF32 {json.dumps(dfg_3d_deviations(rung, planted[rung]))}")
        for i, run in enumerate(sound):
            misses += dfg_3d_misses(f"dfg_3d_spread run {i + 1} lc {rung[0]} nz {rung[1]}", rung, run[rung])
        if not dfg_3d_misses(f"dfg_3d_spread TF32 lc {rung[0]} nz {rung[1]}", rung, planted[rung]):
            unseen.append(f"lc {rung[0]} nz {rung[1]}")
    if misses:
        fail("DFG 3D-1Z spread runs outside their limits: " + "; ".join(misses))
    if unseen:
        fail(f"the DFG 3D-1Z limits did not see kernel B rounded to TF32 on {', '.join(unseen)}")


def drive_dfg_drift(device) -> None:
    """The DFG_DRIFT_RUNS runs of the 3D-1Z rung DFG_DRIFT_RUNG on the card,
    built by `dfg3d_validate.build`, each summary's c_d, c_l, delta-p,
    drift, steps/s and iterations a step logged; each run to the ladder's
    t-end held to the rung's limits at its dtype (`dfg_3d_misses`); fails
    after all ran if any missed."""
    from navierstokes_project_nm4pde_tpu_torch.models import NavierStokesSolver
    from navierstokes_project_nm4pde_tpu_torch.validation import dfg3d_validate, timed_run

    lc, nz = DFG_DRIFT_RUNG
    t_end_ladder = dfg3d_validate.parser().get_default("t_end")
    misses = []
    for dtype, t_end in DFG_DRIFT_RUNS:
        argv = ["--lc", str(lc), "--nz", str(nz), "--t-end", str(t_end)]
        mesh, problem, cfg, n = dfg_args(dfg3d_validate, argv, dtype)
        solver = NavierStokesSolver(mesh, problem, cfg, device=device)
        _, diags, wall = timed_run(solver, n)
        s = dfg3d_validate.summarize(dfg3d_validate.parser().parse_args(argv), problem, diags, n, wall,
                                     solver.space.n_dofs, mesh.n_cells)
        run = f"dfg_drift {dtype} t-end {t_end}"
        log(f"{run}: " + json.dumps({k: s[k] for k in (
            "dofs", "window", "cd", "cl", "delta_p", "cd_drift_rel", "steps_per_sec", "iters_per_step_warm")}))
        if t_end == t_end_ladder:
            misses += dfg_3d_misses(run, DFG_DRIFT_RUNG, s, dtype)
        del solver
        free_card()
    if misses:
        fail("DFG 3D-1Z drift runs outside their limits: " + "; ".join(misses))


def _dfg_check(run: str, key: str, v: float, lo: float, hi: float, what: str, misses: list) -> None:
    ok = lo <= v <= hi
    log(f"  {run}: {key} = {v:.6g}, {what} [{lo:.6g}, {hi:.6g}]: {'inside' if ok else 'MISSED'}")
    if not ok:
        misses.append(f"{run} {key} {v:.6g} outside {what} [{lo:.6g}, {hi:.6g}]")


def dfg_3d_limits(rung, dtype: str = "float32") -> dict:
    """key -> (lo, hi, what): where each quantity of a run's 3D-1Z summary
    on `rung` must lie: DFG_3D_JAX's reading within DFG_3D_RTOL (c_d,
    delta-p) or DFG_3D_ATOL (c_l, the drift), or for a float64 run within
    DFG_3D_F64_TOL."""
    ref, limits = DFG_3D_JAX[rung], {}
    for k in ("cd", "delta_p", "cl", "cd_drift_rel"):
        tol = DFG_3D_F64_TOL if dtype == "float64" else DFG_3D_RTOL if k in ("cd", "delta_p") else \
            DFG_3D_ATOL[rung][k]
        half = tol * abs(ref[k]) if k in ("cd", "delta_p") else tol
        limits[k] = (ref[k] - half, ref[k] + half,
                     f"the JAX package's {ref[k]:.6g} within {tol:g}{' relative' if k in ('cd', 'delta_p') else ''}")
    return limits


def dfg_3d_misses(run: str, rung, s: dict, dtype: str = "float32") -> list:
    """The misses of the 3D-1Z summary `s` of a run on `rung` (each check
    logged): each quantity within `dfg_3d_limits`, and on a DFG_3D_PUBLISHED
    rung c_l and delta-p inside their published intervals."""
    misses = []
    for k, (lo, hi, what) in dfg_3d_limits(rung, dtype).items():
        _dfg_check(run, k, s[k], lo, hi, what, misses)
    if rung in DFG_3D_PUBLISHED:
        for k in ("cl", "delta_p"):
            _dfg_check(run, k, s[k], *s["published"][k], "the published interval", misses)
    return misses


def drive_dfg_full(device, runs, out_dir=None) -> None:
    """The full-length DFG runs `runs` (names of DFG_2D_FULL, and
    "dfg_3d1z": the DFG_3D_LADDER) through each module's `main` on the card,
    each summary logged with the set-up time, peak memory and the kernels'
    launches, each quantity held to its limit (DFG_RE100, DFG_RE200,
    `dfg_3d_misses`); fails after all ran if any missed."""
    import tempfile

    from navierstokes_project_nm4pde_tpu_torch.validation import dfg3d_validate, dfg_validate

    misses = []
    with tempfile.TemporaryDirectory() as tmp:
        out = out_dir or tmp
        jobs = [(run, dfg_validate, [*DFG_2D_FULL[run], "--out-dir", f"{out}/{run}"])
                for run in runs if run in DFG_2D_FULL]
        if "dfg_3d1z" in runs:
            jobs += [(f"dfg_3d1z lc {lc} nz {nz}", dfg3d_validate,
                      ["--lc", str(lc), "--nz", str(nz), "--out-dir", f"{out}/dfg_3d1z_{lc}_{nz}"])
                     for lc, nz in DFG_3D_LADDER]
        for run, mod, argv in jobs:
            r = run_dfg_main(mod, argv, device)
            s = r["summary"]
            n_steps = round((s["window"][1] if mod is dfg3d_validate else float(argv[argv.index("--t-end") + 1]))
                            / s["dt"])
            setup = r["wall"] - n_steps / s["steps_per_sec"]
            log(f"{run}: {r['header']}; {r['wall']:.1f} s in main ({n_steps} steps at {s['steps_per_sec']} steps/s; "
                f"set-up and files {setup:.1f} s); peak device memory {r['peak_gib']:.3f} GiB; "
                f"launches {r['launches']}")
            log(f"{run} summary: {json.dumps(s)}")
            if r["launches"]["macro_build"] <= 0 or r["launches"]["macro_matvec"] <= 0:
                misses.append(f"{run}: a macro kernel never launched ({r['launches']})")
            if run == "dfg_re100":
                for k, ((lo, hi), ref) in DFG_RE100.items():
                    _dfg_check(run, k, s[k], lo * (1 - DFG_EDGE_RTOL), hi * (1 + DFG_EDGE_RTOL),
                               f"the published interval within {DFG_EDGE_RTOL:.0%} of its edges", misses)
                    _dfg_check(run, k, s[k], *sorted((ref * (1 - DFG_RE100_RTOL), ref * (1 + DFG_RE100_RTOL))),
                               f"the JAX package's {ref} within {DFG_RE100_RTOL:.0%}", misses)
            elif run == "dfg_re200":
                for k, ref in DFG_RE200.items():
                    _dfg_check(run, k, s[k], *sorted((ref * (1 - DFG_RE200_RTOL), ref * (1 + DFG_RE200_RTOL))),
                               f"the JAX package's {ref} within {DFG_RE200_RTOL:.0%}", misses)
            else:
                misses += dfg_3d_misses(run, (float(argv[1]), int(argv[3])), s)
    if misses:
        fail("DFG runs outside their limits: " + "; ".join(misses))


def kernel_entry(name: str, r: dict, launches: int) -> dict:
    """A kernel's numbers in the kernels' JSON line, from its record `r`
    (float32's, or the float64 record of its "f64" entry), logged."""
    log(f"{name}: device {r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
        f"({r['bound_ms'] / r['device_ms']:.1%}), plain {r['plain_device_ms']:.4f} ms, library "
        f"{r['lib_device_ms']:.4f} ms, launches {launches}, max abs err {r['err']:.3e}")
    return dict(
        launches=launches, max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        device_ms=r["device_ms"], plain_device_ms=r["plain_device_ms"], lib_device_ms=r["lib_device_ms"],
        share=share(name, r, r["device_ms"]),
        **{k: r[k] for k in ("widths", "shapes", "launches_by_path") if k in r},
    )


def drive_coarse(device) -> None:
    """The frozen coarse solve at the single run's (965k duct, 1 column)
    and the ensemble's (64 x 47k, 64 columns) coarse sizes, in float32 and
    float64 (`coarse_solve_times`)."""
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver

    for label, mesh_kw, config, cols in (
        ("single run", dict(lc=0.024, nz=14), bench_config, 1),
        ("ensemble", ENSEMBLE_MESH, ensemble_config, ENSEMBLE_MEMBERS),
    ):
        mesh = cylinder_duct_3d(**mesh_kw)
        for dtype in ("float32", "float64"):
            solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), config(dtype), device=device)
            coarse_solve_times(f"{label} {dtype}", solver, cols, KERNEL_REPS)
            del solver
            free_card()


# Phases `--only` can run alone: name -> phase(device, kernel records,
# float64 kernel records, the DFG runs' output directory or None).
ONLY_PHASES = {
    "coarse": lambda device, rec, rec64, out: drive_coarse(device),
    "member-product": lambda device, rec, rec64, out: drive_member_product(device),
    "ensemble-cli": lambda device, rec, rec64, out: drive_ensemble_cli(device, rec),
    "ensemble-variants": lambda device, rec, rec64, out: (check_small_ensemble(device),
                                                          check_small_ensembles(device)),
    "multi-device": lambda device, rec, rec64, out: drive_multi_device(device, rec),
    "float64-small": lambda device, rec, rec64, out: check_small_f64(device),
    "unfolded-small": lambda device, rec, rec64, out: check_small_unfolded(device),
    "wide-macro": lambda device, rec, rec64, out: drive_wide_macro(device, rec, rec64),
    "fault7": lambda device, rec, rec64, out: check_fault7(device, rec, rec64),
    "dfg": lambda device, rec, rec64, out: drive_dfg(device, rec, out),
    "dfg_spread": lambda device, rec, rec64, out: drive_dfg_spread(device),
    "dfg_drift": lambda device, rec, rec64, out: drive_dfg_drift(device),
    "dfg_3d_spread": lambda device, rec, rec64, out: drive_dfg_3d_spread(device),
    "dfg_full": lambda device, rec, rec64, out: drive_dfg_full(device, (*DFG_2D_FULL, "dfg_3d1z"), out),
    **{run: functools.partial(lambda run, device, rec, rec64, out: drive_dfg_full(device, (run,), out), run)
       for run in (*DFG_2D_FULL, "dfg_3d1z")},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace 3 single-run, 3 IMEX and 2 ensemble steps into DIR")
    ap.add_argument("--only", nargs="+", choices=sorted(ONLY_PHASES), metavar="PHASE",
                    help=f"build the kernels and run only these phases ({', '.join(sorted(ONLY_PHASES))}); "
                         "prints no kernels record")
    ap.add_argument("--out-dir", help="where the DFG runs write their CSV files (default: a temporary directory)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import numpy as np

    from navierstokes_project_nm4pde_tpu_torch.mesh import cube_mesh, cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder3DProblem,
        EthierSteinmanProblem,
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
    if args.only:
        rec, rec64 = ({k: dict(err=0.0) for k in KERNELS} for _ in range(2))
        for phase in args.only:
            t0 = time.perf_counter()
            ONLY_PHASES[phase](device, rec, rec64, args.out_dir)
            log(f"{phase}: {time.perf_counter() - t0:.1f} s")
        imported = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
        if imported:
            fail(f"imported modules of jax or of the JAX package: {imported[:10]}")
        log(f"chip_smoke: phases {args.only} only, in {time.perf_counter() - t_start:.1f} s")
        return 0

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

    # ---- 4. the ensemble's setup and kernels C and D -----------------------
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
    add_slot_shapes(rec, "ensemble", plans, KERNEL_REPS, base=3 * B)
    coarse_solve_times("ensemble", esolver, B, KERNEL_REPS)
    member_product_times(esolver, KERNEL_REPS)
    member_product_path(esolver, nus)

    # ---- 5. the probes --------------------------------------------------------
    prec = run_probes(KERNEL_REPS)
    rec.update(prec)
    probe_launches = {k: v["launches"] for k, v in prec.items()}
    for name, count in probe_launches.items():
        if count <= 0:
            fail(f"the probe run never launched kernel {name}")

    # ---- 6. short runs against the CPU on a small duct: both paths, variants
    check_small_ensemble(device)
    check_small_ensembles(device)
    check_small_duct(device)
    for name, (changes, mesh_kw) in VARIANT_CHECKS.items():
        mb.reset_launch_counts()
        check_small_duct(device, name, changes, mesh_kw)
        log(f"  kernel A launches by channel count on the card: {dict(sorted(mb.matvec_channels.items()))}")
        wide_macro_launched(name, changes)
    check_small_monolithic(device)
    check_small_precond(device)
    t0 = time.perf_counter()
    check_small_f64(device)
    check_small_unfolded(device)
    log(f"small float64, fold_elem=False and spatial_reorder=False checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, (geometry, spec, steps, rtol) in SMALL_CHECKS.items():
        mb.reset_launch_counts()
        check_small(device, name, *small_geometry(geometry), functools.partial(small_config, spec), steps, rtol)
        if spec[2:]:
            wide_macro_launched(name, spec[2])
    log(f"small 2D, BDF2 and Ethier-Steinman checks: {time.perf_counter() - t0:.1f} s")

    # ---- 7. the main path -------------------------------------------------
    state, d, step_ms, launches = drive_single(
        "single run", solver, WARMUP_STEPS, TIMED_STEPS, ("macro_build", "macro_matvec")
    )
    launches = {k: launches[k] for k in ("macro_build", "macro_matvec")}
    n = TIMED_STEPS
    coarse_solve_times("single run", solver, 1, KERNEL_REPS)

    if args.profile:
        busy = profile_steps(lambda st, k: solver.run(k, state=st), state, 3, args.profile, "single")
        log(f"device idle share, profiled device ms/step against the timed mean: "
            f"{1 - busy * n / sum(step_ms):.4f}")
    del solver, state
    free_card()

    # ---- 8. IMEX convection at 965k: K plus the fine cells (kernels C, D) --
    t0 = time.perf_counter()
    isolver = NavierStokesSolver(
        mesh, Cylinder3DProblem(test_case=2), with_changes(bench_config("float32"), IMEX_RUN),
        device=device,
    )
    isolver.op.onehot  # built at first use: part of this path's setup
    torch.cuda.synchronize()
    n_fine = 0 if isolver.imex is None else isolver.imex.f_idx.numel()
    log(f"imex setup: implicit-cell fraction E_f {isolver.imex_frac:.6f} ({n_fine} of "
        f"{mesh.n_cells} cells), K {isolver.kcsr.cols.numel()} entries; host setup "
        f"{time.perf_counter() - t0:.2f} s (mesh reused)")
    imex_operator_times(isolver, KERNEL_REPS)
    add_slot_shapes(rec, "imex fine", isolver.imex.plans, KERNEL_REPS)
    add_slot_shapes(rec, "imex full", isolver.op.onehot, KERNEL_REPS)
    istate, _, i_ms, _ = drive_single(
        "imex", isolver, WARMUP_STEPS, TIMED_STEPS, ("slot_gather", "slot_reduce"), any_maxiter=False
    )
    if args.profile:
        busy = profile_steps(lambda st, k: isolver.run(k, state=st), istate, 3, args.profile, "imex")
        log(f"imex device idle share, profiled device ms/step against the timed mean: "
            f"{1 - busy * TIMED_STEPS / sum(i_ms):.4f}")
    del isolver, istate
    free_card()

    # ---- 9. the velocity accelerators at 965k on the macro path -----------
    for name, changes in ACCEL_RUNS.items():
        t0 = time.perf_counter()
        asolver = NavierStokesSolver(
            mesh, Cylinder3DProblem(test_case=2), with_changes(bench_config("float32"), changes),
            device=device,
        )
        asolver.macro_mass  # built at first use (with the plan): this path's setup
        if asolver.macro_split:
            asolver.macro_stiff
        torch.cuda.synchronize()
        log(f"{name}: host setup {time.perf_counter() - t0:.2f} s (mesh reused)")
        if asolver.macro_split:
            split_build_times(asolver, KERNEL_REPS)
        drive_single(name, asolver, ACCEL_WARMUP, ACCEL_TIMED, ("macro_build", "macro_matvec"))
        del asolver
        free_card()

    # ---- 9b. the monolithic stepper at 965k (bench.py's monolithic knobs) --
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    msolver = NavierStokesSolver(
        mesh, Cylinder3DProblem(test_case=2), with_changes(bench_config("float32"), MONO_RUN),
        device=device,
    )
    torch.cuda.synchronize()
    log(f"monolithic 965k: host setup {time.perf_counter() - t0:.2f} s (mesh reused), peak device "
        f"memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB after set-up; "
        f"S~ {msolver.op.schur.prod_vals.numel()} pair products")
    add_slot_shapes(rec, "monolithic 965k", msolver.op.onehot, KERNEL_REPS)
    mstate, _, _, mono_launches = drive_single(
        "monolithic 965k", msolver, MONO_WARMUP, MONO_TIMED, ("slot_gather", "slot_reduce")
    )
    _, syncs, its = count_syncs(msolver, mstate, 1)
    log(f"  monolithic 965k: {syncs} host syncs in one step of {its} outer iterations")
    del msolver, mstate
    free_card()

    # ---- 9c. the single run at float64 (kernels A and B in float64) -------
    t0 = time.perf_counter()
    fsolver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), bench_config("float64"), device=device)
    fsolver.macro_mass  # built at first use (with the plan): this path's setup
    fmp = fsolver.macro
    torch.cuda.synchronize()
    log(f"single run float64: host setup {time.perf_counter() - t0:.2f} s (mesh reused); macro B={fmp.B} "
        f"U={fmp.U} c_blk={fmp.c_blk}")
    rec64 = check_kernels(fsolver, KERNEL_REPS, F64_MATVEC_WIDTHS)
    free_card()
    _, d64, _, f64_all = drive_single(
        "single run float64", fsolver, F64_WARMUP, F64_TIMED, ("macro_build_f64", "macro_matvec_f64")
    )
    f64_single = launches_of(f64_all, ("macro_build", "macro_matvec"), "float64", "single run float64")
    del fsolver
    free_card()

    # ---- 9d'. the single run at wide macro blocks (U = 192, 256), both dtypes
    t0 = time.perf_counter()
    wide_paths = drive_wide_macro(device, rec, rec64, mesh, base={"float32": d, "float64": d64})
    log(f"the single run at wide macro blocks: {time.perf_counter() - t0:.1f} s")
    del mesh
    free_card()

    # ---- 9d''. kernels A and B at very wide blocks (Queue 3 fault 7) --------
    t0 = time.perf_counter()
    check_fault7(device, rec, rec64)
    log(f"kernels A and B at very wide blocks: {time.perf_counter() - t0:.1f} s")

    # ---- 9d. the cylinder3d entry point at --dtype float64 (142,692 DoF) ----
    # kernels C and D in float64 on its solver's plan: their float64 records,
    # at the 3 channels of every element pass, and diag C(w)'s 1 beside them
    cli_launches64, heads64 = drive_cylinder_cli(device, dtype="float64")
    c64 = NavierStokesSolver(
        cylinder_duct_3d(**CLI_MESH), Cylinder3DProblem(test_case=2), cylinder3d_config("float64"),
        device=device,
    )
    add_slot_shapes(rec64, "monolithic 142k", c64.op.onehot, KERNEL_REPS, torch.float64, base=3)
    del c64
    free_card()

    # ---- 10. explicit convection on the 46,928-DoF duct ---------------------
    t0 = time.perf_counter()
    xsolver = NavierStokesSolver(
        cylinder_duct_3d(**EXPLICIT_MESH), Cylinder3DProblem(test_case=2),
        with_changes(bench_config("float32"), {"time": dict(convection="explicit")}), device=device,
    )
    xsolver.op.onehot
    torch.cuda.synchronize()
    log(f"explicit setup: {xsolver.space.n_dofs} DoF, dt {xsolver.config.time.dt:g}; host setup "
        f"{time.perf_counter() - t0:.2f} s")
    add_slot_shapes(rec, "explicit full", xsolver.op.onehot, KERNEL_REPS)
    drive_single("explicit", xsolver, WARMUP_STEPS, TIMED_STEPS, ("slot_gather", "slot_reduce"),
                 any_maxiter=False)
    del xsolver
    free_card()

    # ---- 11. the ensemble path ---------------------------------------------
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
    e_launches = launches_of(oh.launch_counts, ("slot_reduce", "slot_gather", "member_product"), "float32",
                             "ensemble")
    launches.update(e_launches)
    launches.update(probe_launches)
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
    log(f"  kernel launches in the timed run: {e_launches}")
    check_run("ensemble", esolver, estate, ed, e_launches)
    e_peak = torch.cuda.max_memory_allocated(device)

    if args.profile:
        busy = profile_steps(
            lambda st, k: run_ensemble(esolver, nus, k, state=st), estate, 2,
            args.profile, "ensemble",
        )
        log(f"ensemble device idle share, profiled device ms/step against the timed mean: "
            f"{1 - busy * ne / sum(e_ms):.4f}")
    add_slot_shapes(rec64, "ensemble plan, 192 (float64 off-path)", esolver.op.onehot, KERNEL_REPS, torch.float64)
    del esolver, estate
    free_card()

    # ---- 11b. the same ensemble with fold_elem=False -----------------------
    t0 = time.perf_counter()
    usolver = NavierStokesSolver(emesh, eproblem, with_changes(ensemble_config("float32"), {
        "numerics": dict(fold_elem=False)}), device=device)
    usolver.op.onehot
    torch.cuda.synchronize()
    log(f"ensemble, fold_elem=False: host setup {time.perf_counter() - t0:.2f} s (mesh reused)")
    ustate, _ = run_ensemble(usolver, nus, ENSEMBLE_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    oh.reset_launch_counts()
    ustate, ud, u_ms = timed_steps(lambda st, k: run_ensemble(usolver, nus, k, state=st), ustate, ENSEMBLE_TIMED)
    u_peak = torch.cuda.max_memory_allocated(device)
    u_launches = launches_of(oh.launch_counts, ("slot_reduce", "slot_gather"), "float32", "ensemble, fold_elem=False")
    log(f"ensemble, fold_elem=False, timed: {ne} steps of {B} members in {sum(u_ms) / 1e3:.4f} s: "
        f"{1e3 * B * ne / sum(u_ms):.4f} member-steps/s (folded {1e3 * B * ne / sum(e_ms):.4f}), "
        f"{sum(u_ms) / ne:.4f} ms/step mean, median {np.median(u_ms):.4f} ms; peak device memory "
        f"{u_peak / 2**30:.3f} GiB (folded {e_peak / 2**30:.3f} GiB); F / S a member a step, mean "
        f"{ud.iters_f.mean():.3f} / {ud.iters_s.mean():.3f} (folded {ed.iters_f.mean():.3f} / "
        f"{ed.iters_s.mean():.3f}); kernel launches {u_launches}")
    check_run("ensemble, fold_elem=False", usolver, ustate, ud, u_launches)
    if not u_peak < e_peak:
        fail(f"ensemble, fold_elem=False: peak {u_peak / 2**30:.3f} GiB is not below the folded "
             f"ensemble's {e_peak / 2**30:.3f} GiB")
    del usolver, ustate

    # ---- 12. the cylinder3d entry point at its defaults (142,692 DoF) -------
    cli_launches, heads = drive_cylinder_cli(device)
    if heads64 != heads:
        fail(f"cylinder3d CLI, float64: its CSV files or headers differ from float32's: {heads64} / {heads}")
    csolver = NavierStokesSolver(
        cylinder_duct_3d(**CLI_MESH), Cylinder3DProblem(test_case=2), cylinder3d_config("float32"),
        device=device,
    )
    cstate, syncs, its = count_syncs(csolver, csolver.initial_state(), 2)
    log(f"cylinder3d defaults: {syncs} host syncs in 2 steps of {its} outer iterations "
        f"({syncs / 2:.1f} a step)")
    monolithic_operator_times(csolver, rec, KERNEL_REPS)
    del csolver, cstate
    free_card()

    # ---- 13. the cylinder2d and convergence entry points ------------------
    t0 = time.perf_counter()
    paths = drive_cylinder2d(device, rec)
    t_2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv_launches = drive_convergence_cli(device)
    paths["convergence CLI"] = conv_launches["float32"]
    nsolver = NavierStokesSolver(
        cube_mesh(16), EthierSteinmanProblem(), small_config(("cli", ["convergence"])), device=device,
    )
    add_slot_shapes(rec, "convergence n=16", nsolver.op.onehot, KERNEL_REPS)
    add_slot_shapes(rec64, "convergence n=16", nsolver.op.onehot, KERNEL_REPS, torch.float64)
    del nsolver
    free_card()
    log(f"the cylinder2d and convergence entry points: cylinder2d {t_2d:.1f} s, convergence "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 13b. the DFG validation runs (2D-2 and 3D-1Z) ---------------------
    t0 = time.perf_counter()
    paths.update(drive_dfg(device, rec, args.out_dir))
    free_card()
    log(f"the DFG validation runs: {time.perf_counter() - t0:.1f} s")

    # ---- 14. the ensemble entry point at its defaults, multi-device runs ----
    t0 = time.perf_counter()
    paths["ensemble CLI"] = drive_ensemble_cli(device, rec)
    free_card()
    t_ens = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths.update(drive_multi_device(device, rec))
    log(f"the ensemble entry point {t_ens:.1f} s, the multi-device runs {time.perf_counter() - t0:.1f} s")
    paths.update({"monolithic 965k": mono_launches, "cylinder3d CLI": cli_launches})
    paths.update({k: v for k, v in wide_paths.items() if k.endswith("float32")})
    for name in ("slot_reduce", "slot_gather", "macro_build", "macro_matvec"):
        rec[name]["launches_by_path"] = {k: v[name] for k, v in paths.items() if v.get(name)}
    # the float64 records' launches: A and B in the float64 single run's
    # timed steps, C and D in the cylinder3d CLI's float64 run, whose plan
    # their records measure; the convergence CLI's float64 launches beside
    paths64 = {"single run float64": f64_single, "cylinder3d CLI float64": cli_launches64,
               "convergence CLI float64": conv_launches["float64"],
               **{k: v for k, v in wide_paths.items() if k.endswith("float64")}}
    for name, r in rec64.items():
        r["launches_by_path"] = {k: v[name] for k, v in paths64.items() if v.get(name)}
        r["launches"] = (f64_single if name.startswith("macro") else cli_launches64)[name]

    imported = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
    if imported:
        fail(f"imported modules of jax or of the JAX package: {imported[:10]}")

    kernels = []
    for name in KERNELS:
        kernels.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{KERNELS[name][0]}",
            replaces=KERNELS[name][1], **kernel_entry(name, rec[name], launches[name]),
            **({"f64": kernel_entry(f"{name} float64", rec64[name], rec64[name]["launches"])}
               if name in rec64 else {}),
        ))
    log(f"chip_smoke: every phase, the kernels' build included, in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
