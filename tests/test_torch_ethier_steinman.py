"""The Ethier-Steinman problem, its functionals, the backflow term and the
`convergence` CLI in the PyTorch port, against the JAX package.

  * the exact velocity, pressure and velocity gradient (the port's by
    `torch.func.jacfwd`, the reference's by `jax.jacfwd`) and the Neumann
    datum h, at seeded points, to 1e-12;
  * the set-up's pieces on cube_mesh(2): the initial state from u0 and p0
    at the reordered mesh's nodes, the Neumann face's rhs, a test forcing's
    rhs, and the error norms, divergence and kinetic energy, to 1e-10;
  * one step at n = 2 and n = 4 (the convergence CLI's defaults at float64):
    the reference's iteration counts, u and p to 1e-10, and the ladder's
    rates above 2.4 (L2) and 1.6 (H1), the bounds of the reference's
    tests/test_ethier_steinman.py;
  * backflow: the facet term's diagonal, operator and rhs against the
    reference's on a velocity with inflow through the outlet, and the
    reference's tests/test_cylinder3d.py setting (2 steps, yosida) against
    the reference;
  * the convergence CLI's files against the reference's CLI at float64.
"""

import csv
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu import cli as jcli
from navierstokes_project_nm4pde_tpu.mesh import cube_mesh as jax_cube
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import EthierSteinmanProblem as JaxES
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.models import ethier_steinman as jes
from navierstokes_project_nm4pde_tpu.ops import functionals as jfn
from navierstokes_project_nm4pde_tpu.ops import operators as jops
from navierstokes_project_nm4pde_tpu_torch import cli as tcli
from navierstokes_project_nm4pde_tpu_torch import config as tconfig
from navierstokes_project_nm4pde_tpu_torch.mesh import cube_mesh, cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder3DProblem,
    EthierSteinmanProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu_torch.models import ethier_steinman as tes
from navierstokes_project_nm4pde_tpu_torch.ops import functionals as tfn
from navierstokes_project_nm4pde_tpu_torch.ops import operators as tops
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-10


def convergence_config(dtype="float64"):
    """The port's RunConfig of `convergence` with no flags, at `dtype`."""
    return tcli._build_config(tcli._parser().parse_args(["convergence", "--dtype", dtype]), None)


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_exact_fields_match_reference():
    x = np.random.default_rng(0).uniform(-1, 1, size=(7, 5, 3))
    xt = torch.as_tensor(x)
    for t in (0.0, 4e-4, 0.37):
        _close(tes.exact_velocity(xt, t), jes.exact_velocity(jnp.asarray(x), t), 1e-12)
        _close(tes.exact_pressure(xt, t), jes.exact_pressure(jnp.asarray(x), t), 1e-12)
        g = tes.exact_velocity_gradient(xt, t)
        assert g.shape == (7, 5, 3, 3) and g.dtype == torch.float64
        _close(g, jes.exact_velocity_gradient(jnp.asarray(x), t), 1e-12)
        _close(tes.neumann_h(xt, t), jes.neumann_h(jnp.asarray(x), t), 1e-12)


@pytest.fixture(scope="module")
def solvers():
    """The reference's and the port's solver on cube_mesh(2) under the
    convergence CLI's defaults at float64."""
    cfg = convergence_config()
    return (JaxSolver(jax_cube(2), JaxES(), jax_config(cfg)),
            NavierStokesSolver(cube_mesh(2), EthierSteinmanProblem(), cfg, device="cpu"))


def test_initial_state_matches_reference(solvers):
    js, ts = solvers
    np.testing.assert_array_equal(ts.mesh.coords, js.mesh.coords)  # the reordered mesh
    jst, tst = js.initial_state(), ts.initial_state()
    for k in ("u", "p", "u_prev", "p_prev"):
        _close(getattr(tst, k), getattr(jst, k), 1e-12)
    assert tst.conv_prev is None and jst.conv_prev is None


def test_neumann_rhs_matches_reference(solvers):
    js, ts = solvers
    for t in (4e-4, 0.1):
        ref = js._neumann_rhs(t, js._dev)
        assert float(jnp.abs(ref).max()) > 0
        _close(ts._external_rhs(t), ref)


def test_forcing_rhs_matches_reference():
    """A test forcing f(x, t) = (sin(x) t, y z, cos(z)) alone, then with the
    Neumann face."""
    def f_j(x, t):
        return jnp.stack([jnp.sin(x[..., 0]) * t, x[..., 1] * x[..., 2], jnp.cos(x[..., 2])], -1)

    def f_t(x, t):
        return torch.stack([torch.sin(x[..., 0]) * t, x[..., 1] * x[..., 2], torch.cos(x[..., 2])], -1)

    cfg = convergence_config()
    for neumann in (False, True):
        kw = {} if neumann else dict(neumann_tag=None, neumann_value=None)
        js = JaxSolver(jax_cube(2), dataclasses.replace(JaxES(), forcing=f_j, **kw), jax_config(cfg))
        ts = NavierStokesSolver(cube_mesh(2), dataclasses.replace(EthierSteinmanProblem(), forcing=f_t, **kw),
                                cfg, device="cpu")
        _close(ts._external_rhs(0.3), js._external_rhs(0.3, js._dev))


def test_error_norms_match_reference(solvers):
    js, ts = solvers
    u = np.random.default_rng(1).normal(size=(ts.space.n_unodes, 3))
    jet = jfn.build_error_tables(js.space, js.geom, degree=5, dtype=np.float64)
    tet = tfn.build_error_tables(ts.space, ts.geom, degree=5, dtype=torch.float64, device="cpu")
    ref = jfn.velocity_error_norms(jet, jnp.asarray(u), jes.exact_velocity, jes.exact_velocity_gradient, 0.2)
    out = tfn.velocity_error_norms(tet, torch.as_tensor(u), tes.exact_velocity, tes.exact_velocity_gradient, 0.2)
    _close([float(v) for v in out], [float(v) for v in ref])
    _close(float(tfn.divergence_l2(tet, torch.as_tensor(u))), float(jfn.divergence_l2(jet, jnp.asarray(u))))
    _close(float(tfn.kinetic_energy(tet, torch.as_tensor(u))), float(jfn.kinetic_energy(jet, jnp.asarray(u))))


def _one_step(n):
    cfg = convergence_config()
    js = JaxSolver(jax_cube(n), JaxES(), jax_config(cfg))
    jst, jd = js.run(1)
    ts = NavierStokesSolver(cube_mesh(n), EthierSteinmanProblem(), cfg, device="cpu")
    tst, td = ts.run(1)
    et = tfn.build_error_tables(ts.space, ts.geom, degree=5, dtype=torch.float64, device="cpu")
    norms = tfn.velocity_error_norms(et, tst.u, tes.exact_velocity, tes.exact_velocity_gradient, tst.t)
    return jst, jd, tst, td, [float(v) for v in norms]


@pytest.fixture(scope="module")
def ladder():
    return {n: _one_step(n) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_one_step_matches_reference(ladder, n):
    jst, jd, tst, td, _ = ladder[n]
    np.testing.assert_array_equal(td.iters, np.asarray(jd.iters))
    assert tst.t == pytest.approx(4e-4, rel=1e-12)
    _close(tst.u, jst.u)
    _close(tst.p, jst.p)


def test_one_step_ladder_converges_at_the_references_rates(ladder):
    (l2c, h1c), (l2f, h1f) = ladder[2][4], ladder[4][4]
    assert math.log2(l2c / l2f) > 2.4, (l2c, l2f)
    assert math.log2(h1c / h1f) > 1.6, (h1c, h1f)


# ---------------------------------------------------------------------------
# backflow
# ---------------------------------------------------------------------------
def backflow_config():
    """The reference's tests/test_cylinder3d.py:90 setting."""
    return tconfig.RunConfig(
        time=tconfig.TimeConfig(dt=2e-4, t_end=4.0),
        solver=tconfig.SolverConfig(rtol=1e-8, restart=40, maxiter=150),
        precond=tconfig.PrecondConfig(kind="yosida", f_iters=4, s_iters=25),
        numerics=tconfig.NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=2),
    )


BF_DUCT = dict(lc=0.12, nz=3)


@pytest.fixture(scope="module")
def backflow_solvers():
    cfg = backflow_config()
    js = JaxSolver(jax_duct(**BF_DUCT), dataclasses.replace(JaxCylinder3D(test_case=2), backflow_tag=1),
                   jax_config(cfg))
    ts = NavierStokesSolver(cylinder_duct_3d(**BF_DUCT),
                            dataclasses.replace(Cylinder3DProblem(test_case=2), backflow_tag=1),
                            cfg, device="cpu")
    return js, ts


def test_backflow_term_matches_reference(backflow_solvers):
    """On a velocity with inflow through half the outlet (the term active):
    diag C, F u, the saddle-point operator and r0, against the reference's."""
    js, ts = backflow_solvers
    n = ts.space.n_unodes
    rng = np.random.default_rng(2)
    w, u = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    p = rng.normal(size=ts.space.n_pnodes)
    nu, dt = 1e-3, 2e-4
    jconv = jops.convection_setup(js.op, jnp.asarray(w), backflow=js.backflow, fold=(nu, dt),
                                  base_e=js._conv_base)
    tconv = tops.convection_setup(ts.op, torch.as_tensor(w), fold=(nu, dt), backflow=ts.backflow)
    assert float(tconv.bf_coef.max()) > 0
    _close(tconv.bf_coef, jconv.bf_coef)
    _close(tconv.diagC, jconv.diagC)
    _close(tops.apply_F(ts.op, nu, dt, tconv, torch.as_tensor(u)),
           jops.apply_F(js.op, nu, dt, jconv, jnp.asarray(u)))
    for o, r in zip(tops.apply_system(ts.op, nu, dt, tconv, torch.as_tensor(u), torch.as_tensor(p)),
                    jops.apply_system(js.op, nu, dt, jconv, jnp.asarray(u), jnp.asarray(p))):
        _close(o, r)
    h = rng.normal(size=(n, 3))
    for o, r in zip(
        tops.apply_rhs_and_r0(ts.op, torch.as_tensor(h), torch.as_tensor(p), nu, dt, tconv, torch.as_tensor(u)),
        jops.apply_rhs_and_r0(js.op, jnp.asarray(h), jnp.asarray(p), nu, dt, jconv, jnp.asarray(u)),
    ):
        _close(o, r)
    _close(tops.apply_convection_self(ts.op, torch.as_tensor(w), backflow=ts.backflow),
           jops.apply_convection_self(js.op, jnp.asarray(w), backflow=js.backflow))


def test_backflow_run_matches_reference(backflow_solvers):
    """2 steps of the reference's backflow setting: the same iteration
    counts and state; the term never takes the macro path."""
    js, ts = backflow_solvers
    jst, jd = js.run(2)
    tst, td = ts.run(2)
    np.testing.assert_array_equal(td.iters, np.asarray(jd.iters))
    _close(tst.u, jst.u, 1e-8)
    _close(tst.p, jst.p, 1e-7)
    proj = dataclasses.replace(backflow_config(), time=tconfig.TimeConfig(dt=2e-4, stepper="projection"))
    tp = NavierStokesSolver(cylinder_duct_3d(lc=0.25, nz=3),
                            dataclasses.replace(Cylinder3DProblem(), backflow_tag=1), proj, device="cpu")
    assert tp.f_apply == "element"
    bad = dataclasses.replace(proj, numerics=dataclasses.replace(proj.numerics, f_apply="macro"))
    with pytest.raises(ValueError, match="backflow"):
        NavierStokesSolver(cylinder_duct_3d(lc=0.25, nz=3),
                           dataclasses.replace(Cylinder3DProblem(), backflow_tag=1), bad, device="cpu")


# ---------------------------------------------------------------------------
# the convergence CLI
# ---------------------------------------------------------------------------
def test_convergence_cli_writes_the_reference_files(tmp_path, capsys):
    """levels 2 4 at float64: convergence.csv to rtol 1e-7, and the same
    table printed."""
    flags = ["convergence", "--levels", "2", "4", "--dtype", "float64"]
    jcli.main([*flags, "--output-dir", str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    tcli.main([*flags, "--device", "cpu", "--output-dir", str(tmp_path / "port")])
    tout = capsys.readouterr().out
    rows = [list(csv.reader(open(tmp_path / k / "convergence.csv"))) for k in ("port", "jax")]
    assert rows[0][0] == rows[1][0] == ["h", "eL2", "eH1"] and len(rows[0]) == 3
    np.testing.assert_allclose(np.asarray(rows[0][1:], float), np.asarray(rows[1][1:], float), rtol=1e-7)
    table = [ln for ln in tout.splitlines() if ln.startswith(("h ", "1 ", "0.5 "))]
    assert table == [ln for ln in jout.splitlines() if ln.startswith(("h ", "1 ", "0.5 "))]
    assert len(table) == 3
