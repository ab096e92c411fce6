"""DFG 2D-2 style validation run: steady inlet, drag/lift/Strouhal tracking.

The counterpart of the reference's `scripts/dfg_validate.py` (BASELINE.json
config 3: "2D cylinder, refined mesh, Re=200 with drag/lift/Strouhal
tracking vs DFG reference").  Runs the steady-inlet DFG configuration
(Cylinder2DProblem test case 4: the constant mean velocity 2 u_m / 3) on a
refined graded channel mesh, with the DFG-standard pressure probes at the
cylinder's front and back, (0.15, 0.2) / (0.25, 0.2), so that delta-p
compares with the published tables (Schaefer-Turek 1996, at Re = 100:
c_d_max 3.22-3.24, c_l_max 0.99-1.01, St 0.295-0.305, delta-p 2.46-2.50).

The inlet is ramped up over `t_ramp` and, for t < `t_kick`, carries a
small transverse oscillation near the shedding frequency, so that the
vortex street develops early; both are off in the measurement window,
which starts at `t_measure`.

    python -m navierstokes_project_nm4pde_tpu_torch.validation.dfg_validate --re 100 \\
        --lc 0.015 --dt 1e-3 --t-end 18 --t-kick 2.5 --t-ramp 1 --t-measure 12

Prints one JSON summary line (stdout) and writes <out-dir>/coeff_re{RE}.csv;
the header line, with the device, goes to stderr.  Runs on the card unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_channel_2d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder2DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.models.cylinder2d import DIAMETER, H
from navierstokes_project_nm4pde_tpu_torch.validation import open_device, timed_run, write_coefficients

NU = 1e-3
# the DFG-standard pressure probes: the cylinder's front and back points
PROBES = ((0.15, 0.2), (0.25, 0.2))


def kicked_inlet(base_g, u_mean: float, t_kick: float, freq: float, t_ramp: float = 0.0):
    """Inlet profile with a start-up ramp and a transverse oscillation.

    The ramp (amplitude scaled by min(t / t_ramp, 1)) avoids the impulsive
    start: on refined meshes the first semi-implicit steps after an
    instantaneous full-speed inlet are convectively unstable at practical
    dt.  The transverse kick 0.1 u_mean sin(2 pi freq t) 4 y (H - y) / H^2
    on the y component, for t < t_kick, breaks the symmetry so that the
    vortex street develops early.  `t` is a Python float, so the switches
    are decided on the host."""

    def g(x: torch.Tensor, t: float) -> torch.Tensor:
        v = base_g(x, t)
        ramp = min(t / t_ramp, 1.0) if t_ramp > 0 else 1.0
        if t < t_kick:
            y = x[:, 1]
            amp = 0.1 * u_mean * math.sin(2.0 * math.pi * freq * t)
            v = torch.stack([v[:, 0], v[:, 1] + amp * 4.0 * y * (H - y) / (H * H)], dim=1)
        return ramp * v

    return g


def strouhal_from_lift(t: np.ndarray, cl: np.ndarray, U: float, D: float):
    """Shedding frequency: Hann-windowed FFT peak of the demeaned lift,
    refined by parabolic interpolation of the spectral peak; returns
    (St, the periods in the window), or (nan, 0) below 16 samples.

    (Zero-crossing counting is not robust here: the per-step solver jitter
    puts weak high-frequency content on top of the O(1) shedding mode.)"""
    s = cl - np.mean(cl)
    if len(s) < 16:
        return float("nan"), 0
    dt = float(t[1] - t[0])
    a = np.abs(np.fft.rfft(s * np.hanning(len(s))))
    freqs = np.fft.rfftfreq(len(s), dt)
    k = int(np.argmax(a[1:])) + 1
    if 1 <= k < len(a) - 1:  # parabolic refinement
        da = 0.5 * (a[k - 1] - a[k + 1])
        dd = a[k - 1] - 2 * a[k] + a[k + 1]
        k_ref = k + (da / dd if dd != 0 else 0.0)
    else:
        k_ref = float(k)
    f = k_ref * freqs[1]
    n_periods = int(f * (t[-1] - t[0]))
    return float(f * D / U), n_periods


def smooth(x: np.ndarray, half: int) -> np.ndarray:
    """Centered moving average (for extrema of a jittery trace)."""
    k = 2 * half + 1
    return np.convolve(x, np.ones(k) / k, mode="same")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--lc", type=float, default=0.03)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--t-end", type=float, default=16.0)
    ap.add_argument("--t-kick", type=float, default=2.0)
    ap.add_argument("--t-ramp", type=float, default=1.0,
                    help="inlet start-up ramp length (0 = impulsive)")
    ap.add_argument("--t-measure", type=float, default=9.0,
                    help="start of the St/coefficient window")
    ap.add_argument("--scheme", default="bdf2")
    ap.add_argument("--stepper", default="projection")
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--out-dir", default="outputDFG")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    return ap


def u_mean_of(args) -> float:
    """Test case 4's mean inlet velocity at Reynolds number args.re:
    Re = U_mean D / nu."""
    return args.re * NU / DIAMETER


def build(args):
    """(mesh, problem, config, n_steps) of the run `args` asks for: the
    problem with the kicked inlet and the DFG probes, float32 (as the
    reference's script runs it)."""
    u_mean = u_mean_of(args)
    problem = Cylinder2DProblem(test_case=4, nu=NU, u_m=1.5 * u_mean)
    # published St at Re = 100 is ~0.30 -> f = St U / D = 3 Hz; the kick
    # frequency needs only to be in the lock-in neighbourhood
    f_kick = 0.3 * u_mean / DIAMETER
    dirichlet = dict(problem.dirichlet)
    dirichlet[0] = kicked_inlet(dirichlet[0], u_mean, args.t_kick, f_kick, t_ramp=args.t_ramp)
    problem = dataclasses.replace(problem, dirichlet=dirichlet, probe_points=PROBES)
    cfg = RunConfig(
        time=TimeConfig(dt=args.dt, t_end=args.t_end, scheme=args.scheme, stepper=args.stepper),
        solver=SolverConfig(rtol=1e-6, maxiter=args.maxiter, tol_mode="b"),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3, s_solver="mg2_cg"),
        numerics=NumericsConfig(dtype="float32", precise_dots=False, steps_per_chunk=args.chunk),
    )
    return cylinder_channel_2d(lc=args.lc), problem, cfg, int(round(args.t_end / args.dt))


def summarize(args, diags, n_steps: int, wall: float, dofs: int, cells: int) -> dict:
    """The reference's summary of a run's diagnostics: extrema of the
    smoothed traces, means, Strouhal number, over t >= t_measure."""
    u_mean = u_mean_of(args)
    t = (np.arange(n_steps) + 1) * args.dt
    cd = np.asarray(diags.c_d, np.float64)
    cl = np.asarray(diags.c_l, np.float64)
    dp = np.asarray(diags.delta_p, np.float64)
    w = t >= args.t_measure
    st, n_per = strouhal_from_lift(t[w], cl[w], u_mean, DIAMETER)
    # extrema of the smoothed traces (a ~T/16 moving average suppresses the
    # per-step jitter; <1% amplitude bias on the shedding mode)
    half = max(1, int(round(0.03 / (st * u_mean / DIAMETER) / args.dt))) if st > 0 else 3
    cd_s, cl_s, dp_s = smooth(cd[w], half), smooth(cl[w], half), smooth(dp[w], half)
    return {
        "re": args.re,
        "dofs": int(dofs),
        "cells": int(cells),
        "dt": args.dt,
        "window": [float(args.t_measure), float(args.t_end)],
        "cd_max": float(np.max(cd_s)),
        "cd_mean": float(np.mean(cd[w])),
        "cl_max": float(np.max(cl_s)),
        "cl_min": float(np.min(cl_s)),
        "cd_max_raw": float(np.max(cd[w])),
        "cl_max_raw": float(np.max(cl[w])),
        "strouhal": st,
        "n_periods": n_per,
        "delta_p_mean": float(np.mean(dp[w])),
        "delta_p_at_clmax": float(dp_s[np.argmax(cl_s)]),
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
        f"# Re={args.re:.0f} mesh {mesh.n_cells} cells, {solver.space.n_dofs} DoFs, "
        f"{n_steps} steps; setup {time.time() - t0:.0f}s; device {device_name}",
        file=sys.stderr, flush=True,
    )
    _, diags, wall = timed_run(solver, n_steps)
    t = (np.arange(n_steps) + 1) * args.dt
    write_coefficients(args.out_dir, f"coeff_re{args.re:.0f}.csv", t, diags)
    summary = summarize(args, diags, n_steps, wall, solver.space.n_dofs, mesh.n_cells)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
