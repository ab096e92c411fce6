"""The port's spans (`utils/profiling.py`) on the CPU.

With no profiler a span is one shared null context and records nothing.
Under a CPU torch.profiler, one single-run step (the benchmark duct's
configuration, macro path, recycled CG) and one 2-member ensemble step
(the sweep's, element passes, plain CG) on a small duct: each step phase
once a step, one Krylov iteration span per counted iteration (the
ensemble's lockstep maxima), and one `host_read` span per read that the
iteration counts and the fixed sites account for.  Set-up keeps each
phase's own seconds.
"""

import json
import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble
from navierstokes_project_nm4pde_tpu_torch.utils import profiling

STEP_PHASES = ("step.guess", "step.gather", "step.fold", "step.build", "step.rhs", "step.f_solve",
               "step.divergence", "step.s_solve", "step.update", "step.diagnostics")
SETUP_PHASES = {"setup.reorder", "setup.space", "setup.operator", "setup.boundary", "setup.f_bound",
                "setup.frozen_schur", "setup.coarse_factor"}
DIAGNOSTIC_COPIES = 5  # drag, lift, c_d, c_l, delta_p
NUS = np.array([1e-3, 2e-3])


def _solver(cfg):
    return NavierStokesSolver(cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu")


@pytest.fixture(scope="module")
def solvers():
    profiling.reset()
    single = _solver(chip_smoke.bench_config())
    ensemble = _solver(chip_smoke.ensemble_config())
    state, _ = single.run(1)  # the plans built at first use
    estate, _ = run_ensemble(ensemble, NUS, 1)
    return dict(single=single, state=state, ensemble=ensemble, estate=estate, setup=profiling.setup_seconds())


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


def test_without_a_profiler_a_span_is_the_shared_null_context(solvers, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.reset()
    a, b = profiling.span("step.guess"), profiling.span("precond.coarse_solve", nc=3, cols=1)
    assert a is b
    with a:
        pass
    solvers["single"].run(1, state=solvers["state"])
    run_ensemble(solvers["ensemble"], NUS, 1, state=solvers["estate"])
    assert profiling.sizes("precond.coarse_solve") == [] and profiling.sizes("schur.banded_matvec") == []


def test_a_single_step_holds_each_phase_and_a_span_per_iteration_and_read(solvers, tmp_path):
    s = solvers["single"]
    profiling.reset()
    (_, d), names = _traced(tmp_path, lambda: s.run(1, state=solvers["state"]))
    assert all(names[p] == 1 for p in STEP_PHASES) and names["run.host_copy"] == 1
    it_f, it_s = int(d.iters_f[0]), int(d.iters_s[0])
    cycles = math.ceil(it_f / s.config.solver.restart)
    assert names["krylov.fgmres.iter"] + names["krylov.cg_recycled.iter"] == it_f + it_s
    assert names["krylov.fgmres.cycle"] == cycles
    # two tolerance norms; FGMRES's first residual, one a cycle and one an
    # iteration; the recycled CG's residual and ||b||, one an iteration;
    # the diagnostics' copies
    assert names["host_read"] == 2 + (1 + cycles + it_f) + (2 + it_s) + DIAGNOSTIC_COPIES
    assert names["host_write"] == 3 * cycles  # FGMRES's mask and coefficients a cycle
    # one Schur matvec and one coarse solve a CG iteration and one for the start
    calls = profiling.sizes("precond.coarse_solve")
    assert names["precond.coarse_solve"] == len(calls) == it_s + 1
    assert names["schur.banded_matvec"] == len(profiling.sizes("schur.banded_matvec")) == it_s + 1
    band = s.proj_schur.band
    assert calls[0] == dict(nc=s.op.coarse.nc, cols=1, factors=1, itemsize=4, form="chol", impl="plain")
    assert profiling.sizes("schur.banded_matvec")[0] == dict(
        blocks=band.vals.shape[0], rows=band.vals.shape[1], width=band.vals.shape[2], n_rows=band.n_rows,
        cols=1, itemsize=4,
    )


def test_an_ensemble_step_counts_its_lockstep_maxima(solvers, tmp_path):
    s = solvers["ensemble"]
    profiling.reset()
    (_, d), names = _traced(tmp_path, lambda: run_ensemble(s, NUS, 1, state=solvers["estate"]))
    assert all(names[p] == 1 for p in STEP_PHASES) and names["run.host_copy"] == 1
    it_f, it_s = int(d.iters_f.max()), int(d.iters_s.max())
    cycles = math.ceil(it_f / s.config.solver.restart)
    assert names["krylov.fgmres.iter"] + names["krylov.cg.iter"] == it_f + it_s
    # the same sites on [n, B] columns; plain CG reads ||b|| and its first
    # residual, then one a lockstep iteration
    assert names["host_read"] == 2 + (1 + cycles + it_f) + (2 + it_s) + DIAGNOSTIC_COPIES
    # and CG's tolerances once a solve (its stop mask is made on the
    # device), and the viscosities once a call
    assert names["host_write"] == 3 * cycles + 1 + 1
    assert profiling.sizes("precond.coarse_solve")[0]["cols"] == len(NUS)
    assert profiling.sizes("schur.banded_matvec")[0]["cols"] == len(NUS)


def test_each_coarse_solve_records_the_path_it_took(solvers, tmp_path):
    """The frozen factor's solves take the plain W form here (the kernel on
    the card); a per-step S~ (proj_schur="step") keeps `cholesky_solve`."""
    profiling.reset()
    _traced(tmp_path, lambda: run_ensemble(solvers["ensemble"], NUS, 1, state=solvers["estate"]))
    frozen = profiling.sizes("precond.coarse_solve")
    step = _solver(chip_smoke.with_changes(chip_smoke.bench_config(), {"numerics": dict(proj_schur="step")}))
    assert step.proj_schur is None
    profiling.reset()
    _traced(tmp_path, lambda: step.run(1))
    per_step = profiling.sizes("precond.coarse_solve")
    assert frozen and {c["impl"] for c in frozen} == {"plain"}
    assert per_step and {c["impl"] for c in per_step} == {"cholesky_solve"}
    assert {c["form"] for c in frozen + per_step} == {"chol"}


def test_set_up_keeps_each_phase_that_ran(solvers):
    setup = solvers["setup"]
    assert SETUP_PHASES | {"setup.macro", "setup.macro_mass", "setup.onehot"} <= set(setup)
    assert all(v >= 0.0 for v in setup.values())


def test_a_set_up_phase_keeps_its_own_seconds(monkeypatch):
    clock = iter([0.0, 1.0, 3.0, 10.0])  # outer in, inner in, inner out, outer out
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    profiling.reset()
    with profiling.setup_phase("outer"):
        with profiling.setup_phase("inner"):
            pass
    assert profiling.setup_seconds() == {"outer": 8.0, "inner": 2.0}
    profiling.reset()
    assert profiling.setup_seconds() == {}


def test_spans_switched_off_record_nothing_under_a_profiler(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", False)
    profiling.reset()

    def work():
        with profiling.span("schur.banded_matvec", blocks=1):
            return torch.ones(3).sum()

    _, names = _traced(tmp_path, work)
    assert not names and profiling.sizes("schur.banded_matvec") == []
