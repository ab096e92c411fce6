"""The PyTorch port's ensemble against the JAX package's Pallas ensemble
path (`numerics.ensemble_onehot=True`, the CLI's `--onehot`).

The same run as tests/test_torch_ensemble.py (float64, small DFG duct,
B = 3 over Re 20-300, 3 steps, scripts/bench_ensemble.py's configuration),
but the JAX side now reduces every velocity-space element pass with its
one-hot Pallas kernel, which accumulates in float32 even for a float64
payload.  The port's reductions stay exact, so the trajectories agree at
float32 level only: measured 5.6e-6 of max |u|, 2.4e-7 of max |p|, 7e-8
of max |c_d|, and 7e-6 of max |c_l| (c_l is a small difference of force
integrals on drag's scale).  Held to 2e-5 of max |ref|, c_l to 2e-5 of
max |c_d|.  The per-member F and S counts were equal and must stay so.
"""

import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.parallel import run_ensemble as jax_run_ensemble
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble
from test_torch_ensemble import STEPS, _members_last, ensemble_config, sweep_nus
from test_torch_port_copies import jax_config


@pytest.fixture(scope="module")
def runs():
    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    jp = JaxCylinder3D(test_case=2)
    nus = sweep_nus(jp)
    jh = JaxSolver(jax_duct(lc=0.22, nz=3), jp, jax_config(ensemble_config(onehot=True)))
    hst3, hd3 = jax_run_ensemble(jh, nus, STEPS)
    ts = NavierStokesSolver(
        mesh, Cylinder3DProblem(test_case=2), ensemble_config(onehot=True), device="cpu"
    )
    tst, td = run_ensemble(ts, nus, STEPS)
    return dict(hst3=hst3, hd3=hd3, tst=tst, td=td)


def test_ensemble_matches_reference_onehot_path(runs):
    """Float32 accumulation on the JAX side bounds the agreement (module
    docstring)."""
    st, td, hs, hd = runs["tst"], runs["td"], runs["hst3"], runs["hd3"]
    np.testing.assert_array_equal(td.iters_f, np.asarray(hd.iters_f))
    np.testing.assert_array_equal(td.iters_s, np.asarray(hd.iters_s))
    for out, ref in ((st.u.numpy(), _members_last(hs.u)), (st.p.numpy(), _members_last(hs.p))):
        assert np.abs(out - ref).max() <= 2e-5 * np.abs(ref).max()
    cd_scale = np.abs(np.asarray(hd.c_d)).max()
    for key, scale in (("c_d", cd_scale), ("c_l", cd_scale), ("delta_p", None)):
        ref = np.asarray(getattr(hd, key))
        scale = np.abs(ref).max() if scale is None else scale
        assert np.abs(getattr(td, key) - ref).max() <= 2e-5 * scale, key
