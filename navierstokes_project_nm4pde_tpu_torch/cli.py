"""Command line of the PyTorch port: the `ensemble` subcommand.

    python -m navierstokes_project_nm4pde_tpu_torch.cli ensemble --fast \\
        [--onehot] [--n-members 64] [--re-min 20] [--re-max 300] \\
        [--lc 0.08] [--nz 4] [--dt 0.01] [--n-steps N] [--output-dir DIR] \\
        [--device cuda]

The same flags and configuration as the reference's `cli.py ensemble`
(its `_common_flags` and `_build_config` are numpy-only and reused), run
by the port's `run_ensemble`; it writes `ensemble.csv` with the
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

from navierstokes_project_nm4pde_tpu.cli import _build_config, _common_flags
from navierstokes_project_nm4pde_tpu_torch.device import pick_device

_NOT_PORTED = ("cylinder2d", "cylinder3d", "convergence")


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
