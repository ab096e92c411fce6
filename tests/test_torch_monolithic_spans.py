"""The monolithic stepper's spans (`utils/profiling.py`) on the CPU.

Under a CPU torch.profiler, steps of the `cylinder3d` entry point's
configuration (the upstream solver: FGMRES(50) under the yosida block
preconditioner, f_iters 6, s_iters 30) on a small duct: each top-level
phase once a step; one `precond.apply` an outer FGMRES iteration, in it
two `precond.f_solve` spans (6 fixed GMRES iterations each) and one
`precond.s_solve` (30 fixed CG iterations), and one `schur.ell_matvec` a
CG iteration (the Jacobi preconditioner reads no S~); the per-step S~
assembled once a step.  The spans change no number: the state and the
diagnostics are bit for bit those of the same steps with no profiler.
"""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from navierstokes_project_nm4pde_tpu_torch import cli
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.utils import profiling

STEP_PHASES = ("step.fold", "step.build", "step.rhs", "step.guess", "step.solve", "step.update",
               "step.diagnostics")
STEPS = 2


def _solver():
    cfg = cli._build_config(cli._parser().parse_args(["cylinder3d"]), None)
    return NavierStokesSolver(cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu")


@pytest.fixture(scope="module")
def mono():
    s = _solver()
    state, _ = s.run(1)  # the plans built at first use
    return s, state


def _steps(s, state):
    """STEPS steps one at a time: (u, p, the stacked diagnostics)."""
    rows = []
    for _ in range(STEPS):
        state, d = s.run(1, state=state)
        rows.append(d)
    diags = {f.name: np.concatenate([getattr(d, f.name) for d in rows]) for f in dataclasses.fields(rows[0])}
    return state.u, state.p, diags


def _traced(tmp_path, fn):
    """fn() under a CPU profiler: (its result, Counter of the program's span
    names in the exported trace, without the prefix)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    pre = profiling.PREFIX
    names = Counter(
        e["name"][len(pre):] for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith(pre)
    )
    return out, names


@pytest.fixture(scope="module")
def traced(mono, tmp_path_factory):
    s, state = mono
    plain = _steps(s, state)
    profiling.reset()
    out, names = _traced(tmp_path_factory.mktemp("trace"), lambda: _steps(s, state))
    sizes = {k: profiling.sizes(k) for k in ("precond.apply", "precond.f_solve", "precond.s_solve",
                                            "schur.ell_matvec", "schur.ell_assemble")}
    return dict(solver=s, plain=plain, out=out, names=names, sizes=sizes)


def test_each_phase_opens_once_a_step(traced):
    names = traced["names"]
    assert all(names[p] == STEPS for p in STEP_PHASES), {p: names[p] for p in STEP_PHASES}
    # the projection step's own phases do not run here
    assert names["step.f_solve"] == names["step.s_solve"] == names["step.gather"] == 0


def test_a_preconditioner_application_an_outer_iteration(traced):
    names, iters = traced["names"], int(traced["out"][2]["iters"].sum())
    assert iters > 0
    assert names["krylov.fgmres.iter"] == names["precond.apply"] == iters
    s = traced["solver"]
    n_u, n_p = s.space.n_unodes * s.space.dim, s.space.n_pnodes
    assert traced["sizes"]["precond.apply"] == [dict(n_u=n_u, n_p=n_p, cols=1, itemsize=4)] * iters


def test_each_application_runs_two_f_solves_and_one_s_solve(traced):
    names, iters, sizes = traced["names"], int(traced["out"][2]["iters"].sum()), traced["sizes"]
    s = traced["solver"]
    assert names["precond.f_solve"] == 2 * iters and names["precond.s_solve"] == iters
    rows = s.space.n_unodes * s.space.dim
    assert sizes["precond.f_solve"] == [dict(iters=6, rows=rows, cols=1)] * (2 * iters)
    assert sizes["precond.s_solve"] == [dict(iters=30)] * iters


def test_the_schur_matvec_opens_once_a_cg_iteration(traced):
    names, iters, sizes = traced["names"], int(traced["out"][2]["iters"].sum()), traced["sizes"]
    schur = traced["solver"].op.schur
    assert names["schur.ell_matvec"] == len(sizes["schur.ell_matvec"]) == 30 * iters
    assert sizes["schur.ell_matvec"][0] == dict(
        rows=tuple(c.shape[0] for c in schur.cols), width=tuple(c.shape[1] for c in schur.cols),
        n_p=traced["solver"].space.n_pnodes, cols=1, vcols=1, itemsize=4, index_itemsize=8,
    )
    # S~ is assembled once a step, in the preconditioner's state
    assert names["schur.ell_assemble"] == STEPS
    assert sizes["schur.ell_assemble"] == [dict(
        n_prod=schur.prod_vals.shape[0], n_slots=schur.mirror.shape[0], cols=1)] * STEPS


def test_the_spans_change_no_number(traced):
    (u0, p0, d0), (u1, p1, d1) = traced["plain"], traced["out"]
    assert torch.equal(u0, u1) and torch.equal(p0, p1)
    assert d0.keys() == d1.keys()
    for k in d0:
        np.testing.assert_array_equal(d0[k], d1[k], err_msg=k)


def test_without_a_profiler_the_spans_record_nothing(mono):
    s, state = mono
    profiling.reset()
    _steps(s, state)
    assert all(profiling.sizes(k) == [] for k in ("precond.apply", "schur.ell_matvec", "schur.ell_assemble"))
