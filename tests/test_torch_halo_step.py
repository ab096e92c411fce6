"""The PyTorch port's owned+halo projection step against the JAX
package's, on 2 local CPU ranks under torch.distributed (gloo).

`HaloProjectionStep` on 2 ranks matches the JAX step on 2 devices (of the
8 virtual CPU devices of tests/conftest.py) at both configurations of
tests/test_halo_step.py (the plain one, 2 steps; guess_order 2 with the
recycled pressure pool, 3 steps): equal F and S counts step for step, and
the JAX test's tolerances (u rtol 1e-6 / atol 5e-9, p rtol 1e-6 / atol
5e-8: the halo slabs and the all-reduced dots sum in another order than
one device).  It matches the port's single-device step the same way, a
JAX HaloStepState carried into the port continues the JAX run, and
`collective_bytes_per_apply` gives a ratio under 0.5.  Each launch
spawns fresh interpreters, so the launches are shared through a
module-scoped fixture, and every launch has a timeout.
"""

import os

import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.parallel import make_device_mesh as jax_device_mesh
from navierstokes_project_nm4pde_tpu.parallel.halo_step import HaloProjectionStep as JaxHaloStep
from navierstokes_project_nm4pde_tpu_torch.config import (
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.parallel import launch, make_device_mesh
from navierstokes_project_nm4pde_tpu_torch.parallel.halo import build_halo_plan, collective_bytes_per_apply
from navierstokes_project_nm4pde_tpu_torch.parallel.halo_step import HaloProjectionStep
from navierstokes_project_nm4pde_tpu_torch.parallel.sharding import _pad_cells
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

TIMEOUT = 300  # seconds a collective may wait before its rank raises


def halo_step_config(extrapolate=False, guess_order=1, s_recycle=0):
    """tests/test_halo_step.py:35 `_cfg`."""
    return RunConfig(
        time=TimeConfig(dt=1e-3, t_end=1.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-10, restart=8, maxiter=80, tol_mode="b",
                            extrapolate_guess=extrapolate, guess_order=guess_order),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3, mg2_form="additive", s_recycle=s_recycle),
        numerics=NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=1,
                                proj_schur="frozen", schur_spmv="auto"),
    )


STEP_CASES = {"plain": (halo_step_config(), 2), "judged": (halo_step_config(True, 2, 3), 3)}


def _step_rank(rank, world, device, cfg, n_steps, carry):
    """Every rank: the halo step from rest (or from a carried state)."""
    solver = NavierStokesSolver(cylinder_duct_3d(lc=0.3, nz=3), Cylinder3DProblem(test_case=2), cfg, device=device)
    hs = HaloProjectionStep(solver, make_device_mesh())
    st = hs.init_state() if carry is None else hs.state_from_numpy(carry)
    iters = []
    for _ in range(n_steps):
        st, it = hs(st)
        iters.append(it)
    return dict(u=hs.unshard(st.u).numpy(), p=st.p.numpy(), iters=iters, state=hs.state_to_numpy(st),
                bytes=hs.ex_u.bytes_sent, n_loc=hs.plan.u.n_loc)


@pytest.fixture(scope="module")
def steps():
    """The JAX HaloProjectionStep on 2 devices (and its state one step
    before the end), the port's on 2 ranks, and the port's continuation of
    the JAX state for the last step."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    out = {}
    for name, (cfg, n) in STEP_CASES.items():
        js = JaxSolver(jax_duct(lc=0.3, nz=3), JaxCylinder3D(test_case=2), jax_config(cfg))
        hs = JaxHaloStep(js, jax_device_mesh(2))
        st, iters = hs.init_state(), []
        for k in range(n):
            if k == n - 1:
                before = {f: None if getattr(st, f) is None else np.asarray(getattr(st, f))
                          for f in ("u", "p", "step", "u_prev", "u_prev2", "p_prev", "spool")}
            st, (itf, its) = hs(st)
            iters.append((int(itf), int(its)))
        ref = dict(u=np.asarray(hs.unshard(st.u)), p=np.asarray(st.p), iters=iters)
        port = launch(_step_rank, 2, cfg, n, None, device="cpu", timeout=TIMEOUT)
        carried = launch(_step_rank, 2, cfg, 1, before, device="cpu", timeout=TIMEOUT)
        out[name] = (ref, port, carried)
    return out


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_halo_step_matches_reference(steps, name):
    ref, port, _ = steps[name]
    for r in port:  # every rank took the same branches and holds the same result
        assert r["iters"] == ref["iters"]
        np.testing.assert_array_equal(r["u"], port[0]["u"])
    assert all(f > 0 for f, _ in ref["iters"])
    np.testing.assert_allclose(port[0]["u"], ref["u"], rtol=1e-6, atol=5e-9)
    np.testing.assert_allclose(port[0]["p"], ref["p"], rtol=1e-6, atol=5e-8)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_halo_step_matches_the_single_device_run(steps, name):
    """The port's halo step against the port's own single-device step
    (tests/test_halo_step.py's check, on the port)."""
    cfg, n = STEP_CASES[name]
    _, port, _ = steps[name]
    solver = NavierStokesSolver(cylinder_duct_3d(lc=0.3, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    st, d = solver.run(n)
    assert [tuple(x) for x in zip(d.iters_f.tolist(), d.iters_s.tolist())] == port[0]["iters"]
    np.testing.assert_allclose(port[0]["u"], st.u.numpy(), rtol=1e-6, atol=5e-9)
    np.testing.assert_allclose(port[0]["p"], st.p.numpy(), rtol=1e-6, atol=5e-8)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_halo_state_carry_over_continues_the_reference_run(steps, name):
    """The JAX HaloStepState one step before the end, carried into the port
    (`state_from_numpy`), takes the JAX last step; `state_to_numpy` gives
    the reference's layout back."""
    ref, _, carried = steps[name]
    assert carried[0]["iters"] == ref["iters"][-1:]
    np.testing.assert_allclose(carried[0]["u"], ref["u"], rtol=1e-6, atol=5e-9)
    np.testing.assert_allclose(carried[0]["p"], ref["p"], rtol=1e-6, atol=5e-8)
    st = carried[0]["state"]
    assert st["u"].shape == (2 * carried[0]["n_loc"], 3) and st["step"] == STEP_CASES[name][1]
    if name == "judged":
        assert st["spool"].shape == (2, 3, st["p"].shape[0]) and np.abs(st["spool"]).max() > 0


def test_halo_volume_and_exchanged_bytes(steps):
    """The exchanged volume of an apply is well under the replicated path's
    all-reduce, at 2 and the reference's 8 devices; a step's ranks count
    what they sent."""
    cfg, _ = STEP_CASES["plain"]
    solver = NavierStokesSolver(cylinder_duct_3d(lc=0.3, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    for n_dev in (2, 8):
        plan = build_halo_plan(_pad_cells(solver.op, n_dev), n_dev, n_vertices=solver.mesh.n_vertices)
        vol = collective_bytes_per_apply(plan, solver.space.dim, itemsize=8)
        assert 0 < vol["ratio"] < 0.5, vol
    _, port, _ = steps["plain"]
    assert all(r["bytes"] > 0 for r in port)
