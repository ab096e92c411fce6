"""One DFG 3D-1Z run through the JAX package or the port, on the CPU, at a
dtype: how chip_smoke.py's DFG_3D_JAX readings were made, and the port's
run to set beside them.

    python tests/dfg3d_reference.py jax --dtype float64 --lc 0.05 --nz 10 --traces "$TMPDIR/jax.npz"
    python tests/dfg3d_reference.py port --dtype float64 --lc 0.05 --nz 10 --traces "$TMPDIR/port.npz"
    python tests/dfg3d_reference.py compare "$TMPDIR/port.npz" "$TMPDIR/jax.npz"

A run takes scripts/dfg3d_validate.py's flags and builds its run: the JAX
package's solver as the script builds it, but at --dtype; the port's
through `validation.dfg3d_validate.build`.  It prints the script's JSON
summary (the port's copy of `summarize`) with the package, the dtype, the
wall and set-up seconds and the steps, and writes each step's c_d, c_l,
delta-p and F and S iteration counts to --traces.  `compare` prints, for
each coefficient, the largest difference of the two files' traces, as a
share of the second's max |value| and step by step, with its step, and
whether the iteration counts are equal at every step.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TRACES = ("c_d", "c_l", "delta_p", "iters_f", "iters_s")


def run(pkg: str, dtype: str, flags: list) -> tuple:
    """(summary, traces) of the 3D-1Z run `flags` through `pkg` ("jax" or
    "port") at `dtype`, on the CPU."""
    sys.path[:0] = [p for p in (str(REPO), str(REPO / "scripts")) if p not in sys.path]
    from navierstokes_project_nm4pde_tpu_torch.validation import dfg3d_validate

    args = dfg3d_validate.parser().parse_args(flags)
    t0 = time.time()
    if pkg == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        if dtype == "float64":
            jax.config.update("jax_enable_x64", True)
        import dfg3d_validate as script

        from navierstokes_project_nm4pde_tpu import config
        from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
        from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem, NavierStokesSolver

        problem = Cylinder3DProblem(test_case=2, u_m=args.u_m)
        dirichlet = dict(problem.dirichlet)
        dirichlet[0] = script.ramped(dirichlet[0], args.t_ramp)
        problem = dataclasses.replace(problem, dirichlet=dirichlet)
        mesh = cylinder_duct_3d(lc=args.lc, nz=args.nz)
        cfg = config.RunConfig(
            time=config.TimeConfig(dt=args.dt, t_end=args.t_end, scheme=args.scheme, stepper="projection"),
            solver=config.SolverConfig(rtol=1e-6, maxiter=args.maxiter, tol_mode="b"),
            precond=config.PrecondConfig(kind="yosida", f_iters=0, s_iters=3, s_solver="mg2_cg"),
            numerics=config.NumericsConfig(dtype=dtype, precise_dots=False, steps_per_chunk=args.chunk))
        solver = NavierStokesSolver(mesh, problem, cfg)
        n = int(round(args.t_end / args.dt))
        n -= n % args.chunk
        setup, t1 = time.time() - t0, time.time()
        state, diags = solver.run(n)
        jax.block_until_ready(state.u)
    elif pkg == "port":
        from navierstokes_project_nm4pde_tpu_torch.models import NavierStokesSolver

        mesh, problem, cfg, n = dfg3d_validate.build(args)
        cfg = dataclasses.replace(cfg, numerics=dataclasses.replace(cfg.numerics, dtype=dtype))
        solver = NavierStokesSolver(mesh, problem, cfg, device="cpu")
        setup, t1 = time.time() - t0, time.time()
        _, diags = solver.run(n)
    else:
        raise ValueError(f"unknown package {pkg!r}")
    wall = time.time() - t1
    traces = {k: np.asarray(getattr(diags, k), np.float64) for k in TRACES}
    summary = dfg3d_validate.summarize(args, problem, diags, n, wall, solver.space.n_dofs, mesh.n_cells)
    summary.update(pkg=pkg, dtype=dtype, wall=wall, setup=setup, n_steps=n)
    return summary, traces


def compare(a: dict, b: dict) -> dict:
    """How far the traces `a` lie from the traces `b`: for each coefficient
    the largest |a - b|, that as a share of max |b|, the largest step-wise
    relative difference, and the (1-based) steps of the two; for the
    iteration counts whether they are equal at every step."""
    out = {}
    for k in ("c_d", "c_l", "delta_p"):
        d = np.abs(a[k] - b[k])
        rel = d / np.maximum(np.abs(b[k]), np.finfo(np.float64).tiny)
        out[k] = dict(max_abs=float(d.max()), step=int(d.argmax()) + 1, of_max=float(d.max() / np.abs(b[k]).max()),
                      max_rel=float(rel.max()), rel_step=int(rel.argmax()) + 1)
    out["counts_equal"] = all(np.array_equal(a[k], b[k]) for k in ("iters_f", "iters_s"))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["compare"]:
        a, b = (dict(np.load(f)) for f in argv[1:3])
        print(json.dumps(compare(a, b)))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    ap.add_argument("pkg", choices=("jax", "port"))
    ap.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    ap.add_argument("--traces", help="an .npz file for each step's coefficients and iteration counts")
    args, flags = ap.parse_known_args(argv)
    summary, traces = run(args.pkg, args.dtype, flags)
    if args.traces:
        np.savez(args.traces, **traces)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
