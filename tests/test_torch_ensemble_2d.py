"""The PyTorch port's ensemble in 2D (`cli.py ensemble --dim 2`) against the
JAX package's `run_ensemble`.

Both packages run 2 members over Re 20-300 for 3 steps at float64 on the
DFG channel `cylinder_channel_2d(lc=0.12)` under the ensemble benchmark's
configuration (tests/test_torch_ensemble.py's, one step a chunk).  Each
member's drag and lift come from `forces_2d` with its own nu.  With equal
per-member F and S counts u is held to rtol 1e-8, p to 1e-7, and c_d, c_l
and the pressure difference to 1e-8.  The JAX ensemble compiles for about
15 s on a CPU, so this file holds it alone.
"""

import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu.mesh import cylinder_channel_2d as jax_channel
from navierstokes_project_nm4pde_tpu.models import Cylinder2DProblem as JaxCylinder2D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.parallel import run_ensemble as jax_run_ensemble
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_channel_2d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder2DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble
from test_torch_ensemble import ensemble_config, sweep_nus
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
MEMBERS = 2


@pytest.fixture(scope="module")
def runs():
    jp = JaxCylinder2D(test_case=2)
    nus = sweep_nus(jp, MEMBERS)
    js = JaxSolver(jax_channel(lc=0.12), jp, jax_config(ensemble_config()))
    jst, jd = jax_run_ensemble(js, nus, STEPS)
    ts = NavierStokesSolver(cylinder_channel_2d(lc=0.12), Cylinder2DProblem(test_case=2), ensemble_config(),
                            device="cpu")
    tst, td = run_ensemble(ts, nus, STEPS)
    return jst, jd, tst, td


def test_2d_ensemble_matches_reference_iteration_counts(runs):
    _, jd, _, td = runs
    assert td.iters_f.shape == (MEMBERS, STEPS)
    np.testing.assert_array_equal(td.iters_f, np.asarray(jd.iters_f))
    np.testing.assert_array_equal(td.iters_s, np.asarray(jd.iters_s))


def test_2d_ensemble_matches_reference_state(runs):
    jst, _, tst, _ = runs
    ju, jp = np.moveaxis(np.asarray(jst.u), 0, -1), np.moveaxis(np.asarray(jst.p), 0, -1)
    assert tst.u.shape[1] == 2
    np.testing.assert_allclose(tst.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(tst.p.numpy(), jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())
    assert not np.allclose(ju[..., 0], ju[..., 1])


@pytest.mark.parametrize("key", ["c_d", "c_l", "delta_p"])
def test_2d_ensemble_matches_reference_functionals(runs, key):
    _, jd, _, td = runs
    ref = np.asarray(getattr(jd, key))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(getattr(td, key), ref, rtol=1e-8, atol=0.0)
