"""Command line of the PyTorch port: the `ensemble` subcommand.

    python -m navierstokes_project_nm4pde_tpu_torch.cli ensemble --fast \\
        [--onehot] [--n-members 64] [--re-min 20] [--re-max 300] \\
        [--lc 0.08] [--nz 4] [--dt 0.01] [--n-steps N] [--output-dir DIR] \\
        [--device cuda]

The same flags and configuration as the reference's `cli.py ensemble`
(the port keeps its own copies of `_common_flags` and `_build_config`),
run by the port's `run_ensemble`; it writes `ensemble.csv` with the
reference's header.  `--onehot` selects only the reference's TPU
reduction layout: the port's ensemble reductions are always kernel C.
The reference's other subcommands, `--dim 2` and `--shard-batch` are not
ported yet and fail with a message.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from navierstokes_project_nm4pde_tpu_torch.config import (
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from navierstokes_project_nm4pde_tpu_torch.device import pick_device

_NOT_PORTED = ("cylinder2d", "cylinder3d", "convergence")


def _build_config(args, defaults):
    """The RunConfig of the parsed flags: the JAX package's `cli.py
    _build_config`, copied (same flags in, equal RunConfig out)."""
    if getattr(args, "fast", False):
        # The benchmarked projection stack (bench.py defaults; measured
        # 2-2.5x over the conservative library defaults at every scale).
        # Overrides the individual solver flags it touches.
        return RunConfig(
            time=TimeConfig(
                dt=args.dt, t_end=args.t_end,
                scheme=getattr(args, "scheme", "bdf1"),
                stepper="projection",
            ),
            solver=SolverConfig(
                rtol=args.rtol, restart=8, maxiter=args.maxiter,
                tol_mode="b", guess_order=2,
            ),
            precond=PrecondConfig(
                kind="yosida", f_iters=0, s_iters=3,
                f_solver="gmres", s_solver="mg2_cg",
                freeze_conv_diag=True, mg2_form="additive",
            ),
            numerics=NumericsConfig(
                dtype=args.dtype, precise_dots=False,
                steps_per_chunk=args.steps_per_chunk,
                reduce_plan="columns", proj_schur="frozen",
                coarse_solve="chol", schur_spmv="auto",
                ensemble_onehot=getattr(args, "onehot", False),
            ),
            test_case=args.test_case if hasattr(args, "test_case") else 2,
            output_dir=args.output_dir,
            output_every=args.output_every,
        )

    return RunConfig(
        time=TimeConfig(
            dt=args.dt, t_end=args.t_end,
            scheme=getattr(args, "scheme", "bdf1"),
            stepper=getattr(args, "stepper", "monolithic"),
        ),
        solver=SolverConfig(
            rtol=args.rtol, restart=args.restart, maxiter=args.maxiter,
            tol_mode=getattr(args, "tol_mode", "r0"),
        ),
        precond=PrecondConfig(
            kind=args.precond, f_iters=args.f_iters, s_iters=args.s_iters,
            f_solver=args.f_solver, s_solver=args.s_solver,
            alpha=0.5 if args.precond == "simple" else 1.0,
        ),
        numerics=NumericsConfig(
            dtype=args.dtype,
            precise_dots=not args.no_precise_dots,
            steps_per_chunk=args.steps_per_chunk,
            ensemble_onehot=getattr(args, "onehot", False),
        ),
        test_case=args.test_case if hasattr(args, "test_case") else 2,
        output_dir=args.output_dir,
        output_every=args.output_every,
    )


def _common_flags(p, dt, t_end, precond):
    """The flags every subcommand takes: the JAX package's `cli.py
    _common_flags`, copied.  --debug-nans, --checkpoint-every, --resume and
    --shard-cells parse as there and have no effect in the port yet."""
    p.add_argument("--mesh", type=str, default=None, help=".msh file (else built-in generator)")
    p.add_argument("--dt", type=float, default=dt)
    p.add_argument("--t-end", type=float, default=t_end)
    p.add_argument("--n-steps", type=int, default=None, help="override step count")
    p.add_argument("--precond", type=str, default=precond)
    p.add_argument("--scheme", type=str, default="bdf1", choices=["bdf1", "bdf2"],
                   help="time scheme (bdf2: live second-order variant)")
    p.add_argument("--stepper", type=str, default="monolithic",
                   choices=["monolithic", "projection"],
                   help="monolithic saddle-point solve (reference parity) or "
                        "incremental pressure-correction splitting (faster)")
    p.add_argument("--fast", action="store_true",
                   help="use the benchmarked projection stack (frozen banded "
                        "Schur + additive two-level CG, plain-Jacobi FGMRES, "
                        "quadratic warm start, rtol vs ||b||); overrides "
                        "--stepper/--precond/--restart/--f-iters/--s-iters/"
                        "--f-solver/--s-solver/--tol-mode")
    p.add_argument("--rtol", type=float, default=1e-6)
    p.add_argument("--tol-mode", type=str, default="r0",
                   choices=["r0", "b", "abs"],
                   help="stopping criterion: relative to the warm-start "
                        "residual (r0, reference-like), to ||rhs|| (b, the "
                        "scipy/PETSc convention), or absolute")
    p.add_argument("--restart", type=int, default=50)
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--f-iters", type=int, default=6)
    p.add_argument("--s-iters", type=int, default=30)
    p.add_argument("--f-solver", type=str, default="gmres",
                   choices=["gmres", "richardson", "chebyshev", "pmg"])
    p.add_argument("--s-solver", type=str, default="cg",
                   choices=["cg", "chebyshev", "mg2", "mg2_cg", "spai", "spai_cg"])
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--nu", type=float, default=None, help="kinematic viscosity override (Re sweeps)")
    p.add_argument("--debug-nans", action="store_true", help="no effect in the port")
    p.add_argument("--no-precise-dots", action="store_true")
    p.add_argument("--steps-per-chunk", type=int, default=10)
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--output-every", type=int, default=0, help="VTU cadence (0=off)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None, help="checkpoint to resume from")
    p.add_argument("--shard-cells", type=int, default=0,
                   help="shard the element batch over N devices (domain "
                        "decomposition; 0 = single device).  VTU snapshots "
                        "gain the reference's `partitioning` subdomain field "
                        "(ref: src/NavierStokes2D.cpp:662-665)")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="navierstokes-torch",
        description="Navier-Stokes benchmarks on the PyTorch port",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("ensemble", help="Reynolds-sweep ensemble")
    _common_flags(pe, dt=0.01, t_end=0.5, precond="asimple")
    pe.add_argument("--dim", type=int, default=3, choices=[2, 3])
    pe.add_argument("--lc", type=float, default=0.08)
    pe.add_argument("--nz", type=int, default=4)
    pe.add_argument("--test-case", type=int, default=2)
    pe.add_argument("--n-members", type=int, default=64)
    pe.add_argument("--re-min", type=float, default=20.0)
    pe.add_argument("--re-max", type=float, default=300.0)
    pe.add_argument("--shard-batch", action="store_true",
                    help="not ported: the port runs an ensemble on one device")
    pe.add_argument("--onehot", action="store_true",
                    help="the reference's one-hot reduction layout (the same "
                         "exact kernel C here)")
    pe.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    for name in _NOT_PORTED:
        sub.add_parser(name, help="not ported to PyTorch yet")
    return parser


def _run_ensemble(args, device) -> None:
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d, read_msh
    from navierstokes_project_nm4pde_tpu_torch.io.csvlog import CSVLogger
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble

    t0 = time.perf_counter()
    mesh = read_msh(args.mesh) if args.mesh else cylinder_duct_3d(lc=args.lc, nz=args.nz)
    problem = Cylinder3DProblem(test_case=args.test_case)
    cfg = _build_config(args, None)
    solver = NavierStokesSolver(mesh, problem, cfg, device=device)

    # Re = U_mean * D / nu; characteristic U = the profile's peak mean
    # velocity over a ramp period (steady profiles are constant in t)
    t_grid = np.linspace(0.0, max(8.0, args.t_end), 65)
    U = float(np.max(np.abs([problem.mean_velocity(t) for t in t_grid]))) or 1.0
    re = np.linspace(args.re_min, args.re_max, args.n_members)
    nus = U * problem.diameter / re
    print(f"Ensemble: {args.n_members} members, Re in [{re[0]:.0f}, {re[-1]:.0f}], "
          f"{mesh.n_cells} cells, {solver.space.n_dofs} DoFs each, on {device}")

    n_steps = args.n_steps or cfg.time.n_steps
    _, bdiags = run_ensemble(solver, nus, n_steps)
    out_dir = args.output_dir or "outputEnsemble"
    rows = [
        (re[m], nus[m], float(np.max(bdiags.c_d[m])), float(np.min(bdiags.c_l[m])),
         float(bdiags.delta_p[m][-1]))
        for m in range(args.n_members)
    ]
    CSVLogger(out_dir).log_table("ensemble.csv", "Re,nu,cd_max,cl_min,delta_p_final", rows)
    print(f"Wrote {out_dir}/ensemble.csv; wall time {time.perf_counter() - t0:.1f}s")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd in _NOT_PORTED:
        raise SystemExit(
            f"the PyTorch port runs only the 'ensemble' subcommand so far; use "
            f"the reference package's cli for '{args.cmd}'"
        )
    if args.dim != 3:
        raise SystemExit("the PyTorch port's ensemble runs the 3D duct only (--dim 3)")
    if args.shard_batch:
        raise SystemExit("--shard-batch is not ported: the port's ensemble runs on one device")
    try:
        device = pick_device(args.device)
    except RuntimeError as e:  # a CUDA device asked for on a machine without one
        raise SystemExit(f"navierstokes-torch: {e} (--device cpu runs on the CPU)") from None
    try:
        _run_ensemble(args, device)
    except ValueError as e:  # a configuration outside the port's slice
        raise SystemExit(f"navierstokes-torch: {e}") from None
    return 0


if __name__ == "__main__":
    sys.exit(main())
