"""An ensemble state carried from the JAX package into the PyTorch port.

JAX runs 2 ensemble steps and 3 ensemble steps from rest (float64, the
small duct and configuration of tests/test_torch_ensemble.py, and the
same with both recycle pools); the port takes the 2-step state through
`ensemble_state_from_numpy` (its pools with it) and runs 1 step, which
must take the JAX third step's F and S counts and match its state and
pools to the trajectory tolerances (u rtol 1e-8).
"""

import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.parallel import run_ensemble as jax_run_ensemble
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu_torch.parallel import (
    ensemble_state_from_numpy,
    ensemble_state_to_numpy,
    run_ensemble,
)
from test_torch_ensemble import STEPS, _members_last, ensemble_config, sweep_nus
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runs():
    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    jp = JaxCylinder3D(test_case=2)
    nus = sweep_nus(jp)
    js = JaxSolver(jax_duct(lc=0.22, nz=3), jp, jax_config(ensemble_config()))
    jst3, jd3 = jax_run_ensemble(js, nus, STEPS)
    jst2, _ = jax_run_ensemble(js, nus, STEPS - 1)
    ts = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), ensemble_config(), device="cpu")
    return dict(nus=nus, jst3=jst3, jd3=jd3, jst2=jst2, ts=ts)


def test_ensemble_state_carry_over_continues_the_reference_run(runs):
    """JAX 2 steps -> the port's ensemble state -> 1 port step = JAX 3 steps."""
    js2 = runs["jst2"]
    arrays = {k: getattr(js2, k) for k in ("u", "p", "t", "step", "u_prev", "p_prev", "u_prev2", "spool")}
    s2 = ensemble_state_from_numpy(arrays, "cpu")
    assert s2.u.shape == (runs["ts"].space.n_unodes, 3, 3) and s2.step == STEPS - 1
    st3, d3 = run_ensemble(runs["ts"], runs["nus"], 1, state=s2)
    np.testing.assert_array_equal(d3.iters_f[:, 0], np.asarray(runs["jd3"].iters_f)[:, -1])
    np.testing.assert_array_equal(d3.iters_s[:, 0], np.asarray(runs["jd3"].iters_s)[:, -1])
    ju = _members_last(runs["jst3"].u)
    np.testing.assert_allclose(st3.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    # and back: the reference's batched layout round-trips
    back = ensemble_state_to_numpy(st3)
    np.testing.assert_array_equal(back["u"], np.moveaxis(st3.u.numpy(), -1, 0))
    assert back["step"].tolist() == [STEPS] * 3
    again = ensemble_state_from_numpy(back, "cpu")
    for k in ("u", "p", "u_prev", "p_prev", "u_prev2"):
        assert torch.equal(getattr(again, k), getattr(st3, k))


POOLS = {"precond": dict(s_recycle=2, f_recycle=2)}


@pytest.fixture(scope="module")
def pool_runs():
    """The same ensemble with both recycle pools (s_recycle = 2, f_recycle
    = 2), which ride the batched State: JAX 2 and 3 steps from rest."""
    import chip_smoke

    cfg = chip_smoke.with_changes(ensemble_config(), POOLS)
    jp = JaxCylinder3D(test_case=2)
    nus = sweep_nus(jp)
    js = JaxSolver(jax_duct(lc=0.22, nz=3), jp, jax_config(cfg))
    jst3, jd3 = jax_run_ensemble(js, nus, STEPS)
    jst2, _ = jax_run_ensemble(js, nus, STEPS - 1)
    ts = NavierStokesSolver(cylinder_duct_3d(lc=0.22, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    return dict(nus=nus, jst3=jst3, jd3=jd3, jst2=jst2, ts=ts)


def test_ensemble_pools_carry_over_continues_the_reference_run(pool_runs):
    """JAX 2 steps (with its spool and fpool, members leading) -> the port's
    ensemble state (members trailing) -> 1 port step = the JAX third step,
    pools included; and the pools round-trip through ensemble_state_to_numpy."""
    r = pool_runs
    js2 = r["jst2"]
    arrays = {k: getattr(js2, k) for k in ("u", "p", "t", "step", "u_prev", "p_prev", "u_prev2",
                                           "spool", "fpool", "fwpool", "conv_prev")}
    assert np.abs(np.asarray(arrays["spool"])).max() > 0 and np.abs(np.asarray(arrays["fpool"])).max() > 0
    s2 = ensemble_state_from_numpy(arrays, "cpu")
    n_p = r["ts"].space.n_pnodes
    assert s2.spool.shape == (2, 2, n_p, 3) and s2.fpool.shape == (2, r["ts"].space.n_dofs - n_p, 3)
    st3, d3 = run_ensemble(r["ts"], r["nus"], 1, state=s2)
    np.testing.assert_array_equal(d3.iters_f[:, 0], np.asarray(r["jd3"].iters_f)[:, -1])
    np.testing.assert_array_equal(d3.iters_s[:, 0], np.asarray(r["jd3"].iters_s)[:, -1])
    for k, rtol in (("u", 1e-8), ("p", 1e-7), ("spool", 1e-7), ("fpool", 1e-6)):
        ref = _members_last(getattr(r["jst3"], k))
        np.testing.assert_allclose(getattr(st3, k).numpy(), ref, rtol=rtol, atol=1e-9 * np.abs(ref).max())
    back = ensemble_state_from_numpy(ensemble_state_to_numpy(st3), "cpu")
    for k in ("spool", "fpool"):
        assert torch.equal(getattr(back, k), getattr(st3, k))
