"""An ensemble state carried from the JAX package into the PyTorch port.

JAX runs 2 ensemble steps and 3 ensemble steps from rest (float64, the
small duct and configuration of tests/test_torch_ensemble.py); the port
takes the 2-step state through `ensemble_state_from_numpy` and runs 1
step, which must take the JAX third step's F and S counts and match its
state to the trajectory tolerances (u rtol 1e-8).
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
from test_torch_port_copies import jax_config


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
