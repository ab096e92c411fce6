"""The PyTorch port's unfolded and unreordered element paths against the
JAX package: numerics.fold_elem=False and numerics.spatial_reorder=False.

With fold_elem=False the step folds no per-element F_e: every element
apply (the velocity operator, the rhs/r0 pass, the saddle-point operator,
the preconditioners' inner solves and the smoothers' power iteration)
evaluates K = M/dt + nu A and C(w) from the quadrature tables, and the
macro path is off.  With spatial_reorder=False the solver runs on the
input mesh's own node order (the frozen Schur on its band there, or the
ELL fallback), and the macro path is off too.

Each case runs 3 steps at float64 on the small DFG duct
`cylinder_duct_3d(lc=0.25, nz=3)` through the JAX solver and through the
port: the projection stepper (the benchmark's configuration), the
monolithic stepper (asimple) and a B = 2 ensemble.  With equal F and S
(or outer) counts the two differ by summation order only, so u is held
to rtol 1e-8 and p to 1e-7 (the standard of tests/test_torch_slice.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.parallel import run_ensemble as jax_run_ensemble
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

DUCT = dict(lc=0.25, nz=3)
STEPS = 3
NUS = (1e-3, 5e-3)


def _config(base: str, **numerics):
    """float64, one step a chunk: "projection" chip_smoke.bench_config,
    "monolithic" the cylinder3d CLI's with asimple, "ensemble"
    chip_smoke.ensemble_config; with `numerics` fields replaced."""
    if base == "projection":
        cfg = chip_smoke.bench_config("float64")
    elif base == "monolithic":
        cfg = chip_smoke.cylinder3d_config("float64", kind="asimple")
    else:
        cfg = chip_smoke.ensemble_config("float64")
    return dataclasses.replace(cfg, numerics=dataclasses.replace(
        cfg.numerics, steps_per_chunk=1, **numerics))


CASES = {
    "fold_elem=False, projection": ("projection", dict(fold_elem=False)),
    "fold_elem=False, monolithic": ("monolithic", dict(fold_elem=False)),
    "fold_elem=False, ensemble": ("ensemble", dict(fold_elem=False)),
    "spatial_reorder=False, projection": ("projection", dict(spatial_reorder=False)),
    "spatial_reorder=False, monolithic": ("monolithic", dict(spatial_reorder=False)),
}


def _run(name):
    base, numerics = CASES[name]
    cfg = _config(base, **numerics)
    js = JaxSolver(jax_duct(**DUCT), JaxCylinder3D(test_case=2), jax_config(cfg))
    ts = NavierStokesSolver(cylinder_duct_3d(**DUCT), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    if base == "ensemble":
        jst, jd = jax_run_ensemble(js, np.asarray(NUS), STEPS)
        tst, td = run_ensemble(ts, np.asarray(NUS), STEPS)
        ju, jp = (np.moveaxis(np.asarray(x), 0, -1) for x in (jst.u, jst.p))
    else:
        jst, jd = js.run(STEPS)
        tst, td = ts.run(STEPS)
        ju, jp = np.asarray(jst.u), np.asarray(jst.p)
    return dict(js=js, ts=ts, jd=jd, td=td, ju=ju, jp=jp, tu=tst.u.numpy(), tp=tst.p.numpy())


@pytest.fixture(scope="module")
def runs():
    """Each case's pair of runs, made at first use and shared."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference_iteration_counts(runs, name):
    r = runs(name)
    np.testing.assert_array_equal(r["td"].iters_f, np.asarray(r["jd"].iters_f))
    np.testing.assert_array_equal(r["td"].iters_s, np.asarray(r["jd"].iters_s))
    maxit = r["ts"].config.solver.maxiter
    assert np.all(r["td"].iters_f < maxit)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference_state(runs, name):
    r = runs(name)
    ju, jp = r["ju"], r["jp"]
    np.testing.assert_allclose(r["tu"], ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(r["tp"], jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())


@pytest.mark.parametrize("name", list(CASES))
def test_paths_as_the_reference_resolves_them(runs, name):
    """No macro path (neither value lets it run); fold_elem=False folds no
    F_e (the reference builds no conv_base); spatial_reorder=False keeps
    the input mesh's order in both packages."""
    r = runs(name)
    ts, js = r["ts"], r["js"]
    assert ts.f_apply == "element" and js._macro is None
    np.testing.assert_array_equal(ts.space.cells_u, np.asarray(js.space.cells_u))
    if "fold_elem" in name:
        assert ts._fold(ts.problem.nu, ts.config.time.dt) is None and js._conv_base is None
    else:
        assert np.array_equal(ts.mesh.cells, cylinder_duct_3d(**DUCT).cells)
        assert js._reorder_method is None


@pytest.mark.parametrize("field", ["fold_elem", "spatial_reorder"])
def test_macro_path_needs_the_fold_and_the_reorder(field):
    cfg = _config("projection", **{field: False, "f_apply": "macro"})
    with pytest.raises(ValueError, match="f_apply='macro'"):
        NavierStokesSolver(cylinder_duct_3d(**DUCT), Cylinder3DProblem(test_case=2), cfg, device="cpu")


@pytest.mark.parametrize("members", [False, True])
def test_unfolded_operators_equal_the_folded(members):
    """apply_F (also in bfloat16), apply_system and apply_rhs_and_r0 from
    unfolded tables equal the folded element matrices' to float64
    rounding, under an IMEX cell weighting, for one run and for members on
    a trailing axis."""
    ts = NavierStokesSolver(cylinder_duct_3d(**DUCT), Cylinder3DProblem(test_case=2),
                            _config("projection"), device="cpu")
    op = ts.op
    rng = np.random.default_rng(3)
    n, n_p, E = op.n_unodes, op.n_pnodes, op.cells_u.shape[0]
    tail = (2,) if members else ()
    T = lambda *s: torch.as_tensor(rng.normal(size=s))  # noqa: E731
    op.imex_scale = torch.as_tensor((rng.uniform(size=E) < 0.7).astype(np.float64))
    w, u, h, p = T(n, 3, *tail), T(n, 3, *tail), T(n, 3, *tail), T(n_p, *tail)
    nu = torch.tensor([1e-3, 4e-3], dtype=torch.float64) if members else 2e-3
    dt = 2e-4
    folded = ops.convection_setup(op, w, fold=(nu, dt))
    unfolded = ops.convection_setup(op, w, fold=None)
    assert unfolded.F_e is None

    def close(a, b):
        a, b = a.double(), b.double()
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())

    close(ops.apply_F(op, nu, dt, unfolded, u), ops.apply_F(op, nu, dt, folded, u))
    for a, b in zip(ops.apply_system(op, nu, dt, unfolded, u, p), ops.apply_system(op, nu, dt, folded, u, p)):
        close(a, b)
    for a, b in zip(ops.apply_rhs_and_r0(op, h, p, nu, dt, unfolded, u),
                    ops.apply_rhs_and_r0(op, h, p, nu, dt, folded, u)):
        close(a, b)
    if not members:
        ub = u.to(torch.bfloat16)
        y, yf = ops.apply_F(op, nu, dt, unfolded, ub), ops.apply_F(op, nu, dt, folded, ub)
        assert y.dtype == torch.bfloat16
        # both round their element contributions to bfloat16 before the
        # reduce: a value a few bfloat16 ulps apart at most
        assert float((y.double() - yf.double()).abs().max()) <= 2 ** -6 * float(yf.double().abs().max())
