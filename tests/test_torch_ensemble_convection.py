"""The PyTorch port's ensemble under explicit and IMEX convection against
the JAX package's `run_ensemble`.

The reference vmaps its whole step, and before it does strips the
assembled constant K and the IMEX fine subset: its members fold
convection (IMEX: weighted per cell) into the element F, or take N(u) on
the rhs with the element K under CG (explicit; under BDF2 the
Adams-Bashforth-2 rhs through `conv_prev`).  Both packages run 3 members
(nu 1e-3, 2e-3, 5e-3) for 3 steps at float64 on the small duct under the
ensemble benchmark's configuration (tests/test_torch_ensemble.py) with
each variant's knobs: equal per-member F and S counts, u to rtol 1e-8 and
p to 1e-7.  Member m equals the single run with nu_m (which takes the
assembled K).  Each JAX ensemble compiles for about 15 s on a CPU.
"""

import numpy as np
import pytest

import chip_smoke
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from test_torch_ensemble import assert_same_ensemble, ensemble_config, ensemble_pair
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)

VARIANTS = {
    "explicit": {"time": dict(convection="explicit")},
    "imex mixed": {"time": dict(convection="imex", imex_umax=9.0, imex_cfl=0.07, dt=1e-3)},
    "explicit bdf2 (AB2)": {"time": dict(convection="explicit", scheme="bdf2")},
}


@pytest.fixture(scope="module")
def runs():
    return {
        name: ensemble_pair(chip_smoke.with_changes(ensemble_config(), ch))
        for name, ch in VARIANTS.items()
    }


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ensemble_convection_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_ensemble(jst, jd, tst, td)
    assert ts.kcsr is not None or name == "explicit bdf2 (AB2)"  # the single run's path
    if name == "explicit bdf2 (AB2)":
        ref = np.moveaxis(np.asarray(jst.conv_prev), 0, -1)
        np.testing.assert_allclose(tst.conv_prev.numpy(), ref, rtol=1e-8, atol=1e-10 * np.abs(ref).max())


def test_ensemble_member_equals_the_single_run(runs):
    """Member 1 of the IMEX ensemble is the single run with nu = 2e-3 (the
    assembled K plus the fine cells' element pass there)."""
    _, _, _, tst, td = runs["imex mixed"]
    cfg = chip_smoke.with_changes(ensemble_config(), VARIANTS["imex mixed"])
    single = NavierStokesSolver(cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2, nu=2e-3), cfg,
                                device="cpu")
    assert single.kcsr is not None and single.imex is not None
    st, d = single.run(3)
    np.testing.assert_array_equal(d.iters_f, td.iters_f[1])
    np.testing.assert_array_equal(d.iters_s, td.iters_s[1])
    u = tst.u[..., 1].numpy()
    np.testing.assert_allclose(st.u.numpy(), u, rtol=1e-8, atol=1e-10 * np.abs(u).max())
