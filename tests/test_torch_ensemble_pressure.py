"""The PyTorch port's ensemble under BDF2 and the pressure solve's variants
against the JAX package's `run_ensemble`: BDF2 (BDF1 on the first step,
then the three-level history), the V(1,1) two-level form and the inverse
coarse solve, each on the ensemble benchmark's configuration
(tests/test_torch_ensemble.py).  Both packages run 3 members for 3 steps
at float64 on the small duct: equal per-member F and S counts, u to rtol
1e-8 and p to 1e-7.  Each JAX ensemble compiles for about 15 s on a CPU.
"""

import pytest

import chip_smoke
from test_torch_ensemble import assert_same_ensemble, ensemble_config, ensemble_pair
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)

VARIANTS = {
    "bdf2": {"time": dict(scheme="bdf2")},
    "mg2_form=v11": {"precond": dict(mg2_form="v11")},
    "coarse_solve=inv": {"numerics": dict(coarse_solve="inv")},
}


@pytest.fixture(scope="module")
def runs():
    return {
        name: ensemble_pair(chip_smoke.with_changes(ensemble_config(), ch))
        for name, ch in VARIANTS.items()
    }


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ensemble_pressure_variant_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_ensemble(jst, jd, tst, td)
    if name == "coarse_solve=inv":
        assert ts.proj_schur.inv_c is not None
