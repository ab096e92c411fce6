"""Command line of the PyTorch port: the reference's three executables
(`cylinder2d`, `cylinder3d`, `convergence`) and the `ensemble` sweep.

    python -m navierstokes_project_nm4pde_tpu_torch.cli cylinder2d \\
        [--lc 0.05] [--test-case 2] [--u-m 1.5] [--fast] [--scheme bdf1] \\
        [--n-steps N] [--steps-per-chunk 10] [--output-dir DIR] [--device cuda]
    python -m navierstokes_project_nm4pde_tpu_torch.cli cylinder3d \\
        [--lc 0.05] [--nz 8] [--n-steps N] [--steps-per-chunk 10] \\
        [--output-dir DIR] [--output-every K] [--checkpoint-every K] \\
        [--resume CKPT] [--device cuda]
    python -m navierstokes_project_nm4pde_tpu_torch.cli convergence \\
        [--levels 2 4 8 16] [--dt 4e-4] [--n-steps N] [--output-dir DIR] \\
        [--device cuda]
    python -m navierstokes_project_nm4pde_tpu_torch.cli ensemble [--fast] \\
        [--dim 3] [--onehot] [--n-members 64] [--re-min 20] [--re-max 300] \\
        [--lc 0.08] [--nz 4] [--dt 0.01] [--n-steps N] [--shard-batch] \\
        [--output-dir DIR] [--device cuda]

The same flags and configuration as the reference's `cli.py` (the port
keeps its own copies of `_common_flags` and `_build_config`).
`cylinder2d` and `cylinder3d` with no flags run the reference's defaults:
the monolithic saddle-point stepper (asimple on the 2D channel, yosida on
the 142,692-DoF duct), writing the reference's CSV files (gmres.csv,
coeff_2.csv, forces_results_<dim>D_<case>case.csv), VTU snapshots every
`--output-every` steps with a .pvd index, `checkpoint.npz` every
`--checkpoint-every` steps and `final.npz`, which either package can
`--resume` from.  `convergence` runs the Ethier-Steinman problem on the
cube ladder `--levels` (one step of dt = 4e-4 a level by default) and
writes convergence.csv and the table of L2 and H1 errors with their
rates.  `ensemble` runs the port's `run_ensemble` and writes
`ensemble.csv` with the reference's header, at the reference's defaults
the monolithic stepper (asimple) and with every flag; `--onehot` selects
only the reference's TPU reduction layout (the port's ensemble reductions
are always kernel C).

Multi-device runs are local ranks under torch.distributed
(`parallel/launch.py`): `cylinder2d` and `cylinder3d` with `--shard-cells
N` launch N ranks that each hold a block of the cells
(`parallel/sharding.py`); rank 0 prints and writes the files, its VTU
snapshots as a .pvtu record with the reference's `partitioning` field.
`ensemble --shard-batch` splits the members over one rank per visible
card when the member count divides evenly (else one rank, the reference's
rule); rank 0 gathers the diagnostics and writes `ensemble.csv`.  Rank r
computes on cuda:(r % device_count).  `--debug-nans` (a JAX debugging
mode) fails with a message.
"""

from __future__ import annotations

import argparse
import os
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
    _common_flags`, copied.  --debug-nans parses as there, and the port
    refuses it."""
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
    p.add_argument("--debug-nans", action="store_true", help="not ported (refused)")
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


def _device_flag(p) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="navierstokes-torch",
        description="Navier-Stokes benchmarks on the PyTorch port",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p2 = sub.add_parser("cylinder2d", help="DFG 2D flow past a cylinder")
    _common_flags(p2, dt=0.01, t_end=8.0, precond="asimple")
    p2.add_argument("--lc", type=float, default=0.05)
    p2.add_argument("--test-case", type=int, default=2,
                    help="1-3: reference cases; 4: steady inlet with correct "
                         "constant mean (DFG 2D-2 validation)")
    p2.add_argument("--u-m", type=float, default=None,
                    help="peak inlet velocity (Re = (2/3) u_m D / nu); default "
                         "1.5 (Re=100); 3.0 gives Re=200")
    _device_flag(p2)
    p3 = sub.add_parser("cylinder3d", help="DFG 3D flow past a cylinder")
    p3.add_argument("--u-m", type=float, default=None,
                    help="peak inlet velocity; default 9.0 (Re=400); 0.45 "
                         "gives the published DFG 3D-1Z steady case at Re=20")
    _common_flags(p3, dt=2e-4, t_end=4.0, precond="yosida")
    p3.add_argument("--lc", type=float, default=0.05)
    p3.add_argument("--nz", type=int, default=8)
    p3.add_argument("--test-case", type=int, default=2)
    _device_flag(p3)
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
                    help="split the members over one rank per visible card")
    pe.add_argument("--onehot", action="store_true",
                    help="the reference's one-hot reduction layout (the same "
                         "exact kernel C here)")
    _device_flag(pe)
    pc = sub.add_parser("convergence", help="Ethier-Steinman convergence study")
    _common_flags(pc, dt=4e-4, t_end=4e-4, precond="asimple")
    pc.add_argument("--levels", type=int, nargs="+", default=[2, 4, 8, 16],
                    help="cube subdivisions (h = 2/n)")
    pc.set_defaults(test_case=2, dtype="float32")
    _device_flag(pc)
    return parser


def _run_cylinder(args, device, dim: int, group=None) -> None:
    """The reference's `_run_cylinder(args, dim)`: set up, run in chunks
    with the per-chunk callback (the CSV logs, the force extrema, gated at
    t > 0.1 in 3D, VTU and checkpoint cadences), then `final.npz` and the
    summary lines.  With a process `group` (`--shard-cells`), this rank's
    block of the cells; rank 0 prints and writes."""
    from navierstokes_project_nm4pde_tpu_torch.device import torch_dtype
    from navierstokes_project_nm4pde_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from navierstokes_project_nm4pde_tpu_torch.io.csvlog import CSVLogger
    from navierstokes_project_nm4pde_tpu_torch.io.vtu import (
        write_pvd,
        write_vtu,
        write_vtu_with_pvtu_record,
    )
    from navierstokes_project_nm4pde_tpu_torch.mesh import (
        cylinder_channel_2d,
        cylinder_duct_3d,
        read_msh,
    )
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder2DProblem,
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.utils.logging import is_main_process, pcout
    from navierstokes_project_nm4pde_tpu_torch.utils.signal import strouhal_number
    from navierstokes_project_nm4pde_tpu_torch.utils.timers import Timer

    t_total = Timer(sync=False).start()
    main = is_main_process()
    if args.mesh:
        mesh = read_msh(args.mesh)
    elif dim == 2:
        mesh = cylinder_channel_2d(lc=args.lc)
    else:
        mesh = cylinder_duct_3d(lc=args.lc, nz=args.nz)
    pcout(f"Mesh: {mesh.n_cells} cells, {mesh.n_vertices} vertices")
    nu_kw = {} if args.nu is None else {"nu": args.nu}
    if args.u_m is not None:
        nu_kw["u_m"] = args.u_m
    problem = (Cylinder2DProblem if dim == 2 else Cylinder3DProblem)(test_case=args.test_case, **nu_kw)
    cfg = _build_config(args, None)
    solver = NavierStokesSolver(mesh, problem, cfg, device=device)
    sp = solver.space
    pcout(f"DoFs: velocity={sp.n_udofs} pressure={sp.n_pnodes} total={sp.n_dofs} (on {device})")

    cell_part = None
    if group is not None:
        import torch.distributed as dist

        from navierstokes_project_nm4pde_tpu_torch.parallel import cell_partitioning, shard_solver

        shard_solver(solver, group)
        cell_part = cell_partitioning(solver, group)
        pcout(f"Sharded cells over {dist.get_world_size(group)} ranks "
              f"(torch.distributed, {dist.get_backend(group)})")

    out_dir = args.output_dir or f"output{dim}D"
    log = CSVLogger(out_dir) if main else None
    vtu_entries = []
    state = (
        load_checkpoint(args.resume, dtype=torch_dtype(args.dtype), device=device)
        if args.resume else solver.initial_state()
    )
    n_steps = args.n_steps or cfg.time.n_steps
    out_every = args.output_every or 0
    cd_max, cl_min = -np.inf, np.inf
    done = {"n": int(state.step)}

    # The run's true mean inlet velocity U(t) in numpy (the gmres.csv Re
    # column and the Strouhal velocity), as the reference's CLI computes it:
    # 2D mean 2 u_m / 3 (ramped in case 2), 3D mean 4 u_m / 9 (ramped in
    # case 3).
    u_m = args.u_m if args.u_m is not None else (1.5 if dim == 2 else 9.0)
    base_mean = 2.0 * u_m / 3.0 if dim == 2 else 4.0 * u_m / 9.0
    ramped = args.test_case == (2 if dim == 2 else 3)

    def inlet_mean_np(t):
        t = np.asarray(t, dtype=float)
        if args.test_case == 1:
            return np.zeros_like(t)
        return base_mean * (np.sin(np.pi * t / 8.0) if ramped else np.ones_like(t))

    # `time solve` = the chunk's wall time over its steps; `time prec` =
    # the one-time set-up on the first row, 0 after (the reference's CLI)
    now0 = time.perf_counter()
    clock = {"last": now0, "setup": now0 - t_total._t0}

    def callback(solver, state, diags):
        nonlocal cd_max, cl_min
        now = time.perf_counter()
        chunk_wall, clock["last"] = now - clock["last"], now
        k = len(diags.iters)
        steps = np.arange(done["n"] + 1, done["n"] + k + 1)
        times = steps * cfg.time.dt
        done["n"] += k
        if not main:  # rank 0 logs and writes
            return
        re = (problem.diameter * inlet_mean_np(times) / problem.nu).astype(int)
        log.log_gmres(times, re, diags.iters)
        log.log_coefficients(steps, diags.c_d, diags.c_l)
        t_prec = np.zeros(k)
        if clock["setup"] is not None:
            t_prec[0], clock["setup"] = clock["setup"], None
        log.log_forces(
            f"forces_results_{dim}D_{args.test_case}case.csv",
            times, diags.drag, diags.lift, diags.c_d, diags.c_l,
            t_prec=t_prec, t_solve=np.full(k, chunk_wall / k),
        )
        # force extrema: 3D from t > 0.1 on (the reference's gate), 2D all
        sel = times > 0.1 if dim == 3 else np.ones(k, dtype=bool)
        if np.any(sel):
            cd_max = max(cd_max, np.max(diags.c_d[sel]))
            cl_min = min(cl_min, np.min(diags.c_l[sel]))
        it, res = diags.iters[-1], diags.residual[-1]
        pcout(
            f"n = {done['n']:4d}, t = {times[-1]:.4f}: {it} GMRES iters, "
            f"residual {res:.3e}, c_d {diags.c_d[-1]:.4f}, c_l {diags.c_l[-1]:.4f}"
        )
        if out_every and (done["n"] % out_every == 0 or done["n"] >= n_steps):
            u, p = state.u.cpu().numpy(), state.p.cpu().numpy()
            if cell_part is not None:  # the reference's piece files and .pvtu record
                path = write_vtu_with_pvtu_record(out_dir, f"solution_{done['n']:06d}", solver.space,
                                                  u, p, partitioning=cell_part)
            else:
                path = os.path.join(out_dir, f"solution_{done['n']:06d}.vtu")
                write_vtu(path, solver.space, u, p)
            vtu_entries.append((float(state.t), path))
        if args.checkpoint_every and done["n"] % args.checkpoint_every == 0:
            save_checkpoint(os.path.join(out_dir, "checkpoint.npz"), state)

    state, diags = solver.run(n_steps - int(state.step), state=state, callback=callback)

    if vtu_entries:
        write_pvd(os.path.join(out_dir, "solution.pvd"), vtu_entries)
    if main:
        save_checkpoint(os.path.join(out_dir, "final.npz"), state)

    pcout("=" * 47)
    pcout(f"Drag Coefficient Max ----->   {cd_max}")
    pcout(f"Lift Coefficient Min ----->   {cl_min}")
    pcout(f"Pressure difference (P(A) - P(B)) = {diags.delta_p[-1] if len(diags.delta_p) else float('nan')}")
    t_grid = np.arange(1, n_steps + 1) * cfg.time.dt
    U_char = float(np.max(np.abs(inlet_mean_np(t_grid)))) if n_steps > 0 else 0.0
    st = strouhal_number(diags.c_l, cfg.time.dt, diameter=problem.diameter, velocity=U_char or 1.0)
    pcout(f"Strouhal number (from c_l) = {st:.4f}")
    pcout(f"Total wall time: {t_total.stop():.2f} s")


def _run_convergence(args, device) -> dict:
    """The reference's `_run_convergence`: the Ethier-Steinman problem on
    each cube of the ladder, its L2 and H1 velocity errors at the end time,
    convergence.csv and the table with its rates.  Returns the rates."""
    from navierstokes_project_nm4pde_tpu_torch.device import torch_dtype
    from navierstokes_project_nm4pde_tpu_torch.io.csvlog import CSVLogger
    from navierstokes_project_nm4pde_tpu_torch.mesh import cube_mesh
    from navierstokes_project_nm4pde_tpu_torch.models import (
        EthierSteinmanProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.models.ethier_steinman import (
        exact_velocity,
        exact_velocity_gradient,
    )
    from navierstokes_project_nm4pde_tpu_torch.ops.functionals import (
        build_error_tables,
        velocity_error_norms,
    )
    from navierstokes_project_nm4pde_tpu_torch.utils.tables import ConvergenceTable
    from navierstokes_project_nm4pde_tpu_torch.utils.timers import Timer

    timer = Timer(sync=False).start()
    table = ConvergenceTable()
    out_dir = args.output_dir or "outputConvergence"
    log = CSVLogger(out_dir)
    hs, l2s, h1s = [], [], []
    # the mesh ladder: n subdivisions of [-1, 1]^3, h = 2/n
    for n in args.levels:
        mesh = cube_mesh(n)
        solver = NavierStokesSolver(mesh, EthierSteinmanProblem(), _build_config(args, None), device=device)
        n_steps = args.n_steps or max(1, solver.config.time.n_steps)
        state, diags = solver.run(n_steps)
        et = build_error_tables(solver.space, solver.geom, degree=5,
                                dtype=torch_dtype(args.dtype), device=device)
        l2, h1 = velocity_error_norms(
            et, state.u, exact_velocity, exact_velocity_gradient, float(state.t)
        )
        h = 2.0 / n
        print(
            f"h={h:.3f}: cells={mesh.n_cells} dofs={solver.space.n_dofs} "
            f"L2={float(l2):.6e} H1={float(h1):.6e} iters={list(diags.iters)}"
        )
        hs.append(h)
        l2s.append(float(l2))
        h1s.append(float(h1))
        table.add_row(h, L2=float(l2), H1=float(h1))
    log.log_convergence(hs, l2s, h1s)
    print(table.format())
    print(f"Time taken to solve ENTIRE Navier Stokes problem: {timer.stop():.2f} s")
    return table.rates()


def _run_ensemble(args, device, group=None) -> None:
    """The reference's `_run_ensemble`: the Reynolds sweep through
    `run_ensemble`, and `ensemble.csv`.  With a process `group`
    (`--shard-batch`), this rank runs its contiguous share of the members,
    and rank 0 gathers every member's diagnostics and writes the file."""
    from navierstokes_project_nm4pde_tpu_torch.io.csvlog import CSVLogger
    from navierstokes_project_nm4pde_tpu_torch.utils.logging import pcout
    from navierstokes_project_nm4pde_tpu_torch.mesh import (
        cylinder_channel_2d,
        cylinder_duct_3d,
        read_msh,
    )
    from navierstokes_project_nm4pde_tpu_torch.models import (
        Cylinder2DProblem,
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble

    t0 = time.perf_counter()
    if args.mesh:
        mesh = read_msh(args.mesh)
    elif args.dim == 2:
        mesh = cylinder_channel_2d(lc=args.lc)
    else:
        mesh = cylinder_duct_3d(lc=args.lc, nz=args.nz)
    problem = (Cylinder2DProblem if args.dim == 2 else Cylinder3DProblem)(test_case=args.test_case)
    cfg = _build_config(args, None)
    solver = NavierStokesSolver(mesh, problem, cfg, device=device)

    # Re = U_mean * D / nu; characteristic U = the profile's peak mean
    # velocity over a ramp period (steady profiles are constant in t)
    t_grid = np.linspace(0.0, max(8.0, args.t_end), 65)
    U = float(np.max(np.abs([problem.mean_velocity(t) for t in t_grid]))) or 1.0
    re = np.linspace(args.re_min, args.re_max, args.n_members)
    nus = U * problem.diameter / re
    pcout(f"Ensemble: {args.n_members} members, Re in [{re[0]:.0f}, {re[-1]:.0f}], "
          f"{mesh.n_cells} cells, {solver.space.n_dofs} DoFs each, on {device}")

    n_steps = args.n_steps or cfg.time.n_steps
    mine = slice(None)
    if group is not None:
        import torch.distributed as dist

        n, r = dist.get_world_size(group), dist.get_rank(group)
        share = args.n_members // n
        mine = slice(r * share, (r + 1) * share)
        pcout(f"Sharded members over {n} ranks, {share} each (torch.distributed, "
              f"{dist.get_backend(group)})")
    _, bdiags = run_ensemble(solver, nus[mine], n_steps)
    cols = [np.max(bdiags.c_d, axis=1), np.min(bdiags.c_l, axis=1), bdiags.delta_p[:, -1]]
    if group is not None:
        parts = [None] * dist.get_world_size(group) if dist.get_rank(group) == 0 else None
        dist.gather_object(cols, parts, dst=0, group=group)
        if dist.get_rank(group) != 0:
            return
        cols = [np.concatenate([part[i] for part in parts]) for i in range(3)]
    out_dir = args.output_dir or "outputEnsemble"
    rows = [
        (re[m], nus[m], float(cols[0][m]), float(cols[1][m]), float(cols[2][m]))
        for m in range(args.n_members)
    ]
    CSVLogger(out_dir).log_table("ensemble.csv", "Re,nu,cd_max,cl_min,delta_p_final", rows)
    pcout(f"Wrote {out_dir}/ensemble.csv; wall time {time.perf_counter() - t0:.1f}s")


def _cylinder_rank(rank, world_size, device, args, dim) -> dict:
    """One rank of `cylinder<dim>d --shard-cells`; returns the rank's kernel
    launches."""
    from navierstokes_project_nm4pde_tpu_torch.parallel import make_device_mesh

    _run_cylinder(args, device, dim, group=make_device_mesh())
    return _rank_launches()


def _ensemble_rank(rank, world_size, device, args) -> dict:
    """One rank of `ensemble --shard-batch`; returns the rank's kernel
    launches."""
    from navierstokes_project_nm4pde_tpu_torch.parallel import make_device_mesh

    _run_ensemble(args, device, group=make_device_mesh())
    return _rank_launches()


def _rank_launches() -> dict:
    """This process's kernel launch counts (a rank's report to `launch`)."""
    from navierstokes_project_nm4pde_tpu_torch.ops import macroblock, onehot

    return {"kernel_launches": {**macroblock.launch_counts, **onehot.launch_counts}}


def _batch_ranks(n_members: int, device) -> int:
    """The reference's --shard-batch rule: one rank per visible card when
    the members divide evenly over them, else one."""
    import torch

    n = max(1, torch.cuda.device_count()) if device.type == "cuda" else 1
    return n if n_members % n == 0 else 1


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.debug_nans:
        raise SystemExit("--debug-nans is not ported (it is a JAX debugging mode)")
    if args.shard_cells and args.cmd not in ("cylinder2d", "cylinder3d"):
        raise SystemExit("--shard-cells shards cylinder2d and cylinder3d runs")
    try:
        device = pick_device(args.device)
    except RuntimeError as e:  # a CUDA device asked for on a machine without one
        raise SystemExit(f"navierstokes-torch: {e} (--device cpu runs on the CPU)") from None
    from navierstokes_project_nm4pde_tpu_torch.parallel.launch import launch

    run = {
        "cylinder2d": lambda a, d: _run_cylinder(a, d, dim=2),
        "cylinder3d": lambda a, d: _run_cylinder(a, d, dim=3),
        "convergence": _run_convergence,
        "ensemble": _run_ensemble,
    }[args.cmd]
    if args.shard_cells:
        run = lambda a, d: launch(_cylinder_rank, a.shard_cells, a, int(a.cmd[-2]),  # noqa: E731
                                  device=d.type)
    elif args.cmd == "ensemble" and args.shard_batch:
        run = lambda a, d: launch(_ensemble_rank, _batch_ranks(a.n_members, d), a,  # noqa: E731
                                  device=d.type)
    try:
        run(args, device)
    except ValueError as e:  # a configuration outside the port's slice
        raise SystemExit(f"navierstokes-torch: {e}") from None
    return 0


if __name__ == "__main__":
    sys.exit(main())
