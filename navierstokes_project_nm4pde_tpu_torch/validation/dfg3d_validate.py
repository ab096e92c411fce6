"""DFG 3D-1Z validation run: steady inlet, Re = 20, drag/lift/delta-p.

The counterpart of the reference's `scripts/dfg3d_validate.py`.  The
reference's 3D executable hardcodes u_m = 9 (Re = 400, where no published
DFG table applies); with u_m = 0.45 the same geometry and profile is the
published DFG 3D-1Z benchmark (Schaefer-Turek 1996, circular cylinder,
steady): mean U = 4 u_m / 9 = 0.2, Re = U D / nu = 20, and the flow
converges to a steady state with
  c_d in [6.05, 6.25],  c_l in [0.008, 0.010],  delta-p in [0.165, 0.175]
(coefficients normalised by the frontal area D H; probes at the cylinder's
front and back, (0.45, 0.2, 0.205) / (0.55, 0.2, 0.205), the model's own
probe points).

Runs with an inlet start-up ramp (impulsive starts are convectively harsh
on refined meshes), steps to t_end, and reports the tail window's means
and the relative drift of c_d across it, so that steadiness is checkable.

    python -m navierstokes_project_nm4pde_tpu_torch.validation.dfg3d_validate \\
        --lc 0.05 --nz 10 --dt 4e-3 --t-end 3

Prints one JSON summary line (stdout) and writes <out-dir>/coeff_3d1z.csv;
the header line, with the device, goes to stderr.  Runs on the card unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.config import (
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.validation import open_device, timed_run, write_coefficients

# Schaefer-Turek 1996, DFG 3D-1Z
PUBLISHED = {"cd": [6.05, 6.25], "cl": [0.008, 0.01], "delta_p": [0.165, 0.175]}


def ramped(base_g, t_ramp: float):
    """`base_g` scaled by min(t / t_ramp, 1) (t a Python float)."""

    def g(x: torch.Tensor, t: float) -> torch.Tensor:
        ramp = min(t / t_ramp, 1.0) if t_ramp > 0 else 1.0
        return ramp * base_g(x, t)

    return g


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--u-m", type=float, default=0.45, help="Re = 4 u_m/9 * D/nu")
    ap.add_argument("--lc", type=float, default=0.05)
    ap.add_argument("--nz", type=int, default=10)
    ap.add_argument("--dt", type=float, default=4e-3)
    ap.add_argument("--t-end", type=float, default=3.0)
    ap.add_argument("--t-ramp", type=float, default=0.5)
    ap.add_argument("--t-measure", type=float, default=None,
                    help="tail window start (default: last 20%%)")
    ap.add_argument("--scheme", default="bdf2")
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--out-dir", default="outputDFG")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    return ap


def build(args):
    """(mesh, problem, config, n_steps) of the run `args` asks for: the
    ramped inlet, float32 (as the reference's script runs it), and a
    multiple of the chunk in steps (the reference compiles one chunk)."""
    problem = Cylinder3DProblem(test_case=2, u_m=args.u_m)
    dirichlet = dict(problem.dirichlet)
    dirichlet[0] = ramped(dirichlet[0], args.t_ramp)
    problem = dataclasses.replace(problem, dirichlet=dirichlet)
    cfg = RunConfig(
        time=TimeConfig(dt=args.dt, t_end=args.t_end, scheme=args.scheme, stepper="projection"),
        solver=SolverConfig(rtol=1e-6, maxiter=args.maxiter, tol_mode="b"),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3, s_solver="mg2_cg"),
        numerics=NumericsConfig(dtype="float32", precise_dots=False, steps_per_chunk=args.chunk),
    )
    n_steps = int(round(args.t_end / args.dt))
    n_steps -= n_steps % args.chunk
    return cylinder_duct_3d(lc=args.lc, nz=args.nz), problem, cfg, n_steps


def reynolds(args, problem) -> float:
    return 4.0 * args.u_m / 9.0 * problem.diameter / problem.nu


def summarize(args, problem, diags, n_steps: int, wall: float, dofs: int, cells: int) -> dict:
    """The reference's summary: tail-window means and c_d's drift."""
    t = (np.arange(n_steps) + 1) * args.dt
    cd = np.asarray(diags.c_d, np.float64)
    cl = np.asarray(diags.c_l, np.float64)
    dp = np.asarray(diags.delta_p, np.float64)
    t_meas = args.t_measure if args.t_measure is not None else 0.8 * t[-1]
    w = t >= t_meas
    # steadiness: relative drift of c_d across the tail window
    drift = (cd[w][-1] - cd[w][0]) / np.mean(cd[w])
    return {
        "case": "DFG 3D-1Z (steady, circular cylinder)",
        "re": round(reynolds(args, problem), 2),
        "dofs": int(dofs),
        "cells": int(cells),
        "dt": args.dt,
        "window": [float(t_meas), float(t[-1])],
        "cd": float(np.mean(cd[w])),
        "cl": float(np.mean(cl[w])),
        "delta_p": float(np.mean(dp[w])),
        "cd_drift_rel": float(drift),
        "published": PUBLISHED,
        "steps_per_sec": round(n_steps / wall, 3),
        "iters_per_step_warm": float(np.mean(np.asarray(diags.iters)[w])),
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device, device_name = open_device(args.device)
    t0 = time.time()
    mesh, problem, cfg, n_steps = build(args)
    solver = NavierStokesSolver(mesh, problem, cfg, device=device)
    print(
        f"# 3D-1Z Re={reynolds(args, problem):.0f} mesh {mesh.n_cells} cells, "
        f"{solver.space.n_dofs} DoFs, {n_steps} steps; setup {time.time() - t0:.0f}s; "
        f"device {device_name}",
        file=sys.stderr, flush=True,
    )
    _, diags, wall = timed_run(solver, n_steps)
    t = (np.arange(n_steps) + 1) * args.dt
    write_coefficients(args.out_dir, "coeff_3d1z.csv", t, diags)
    summary = summarize(args, problem, diags, n_steps, wall, solver.space.n_dofs, mesh.n_cells)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
