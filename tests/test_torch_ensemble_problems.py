"""The PyTorch port's ensemble on problems with boundary and volume terms
against the JAX package's `run_ensemble`: the backflow stabilisation on
the duct's outlet (each member's own facet coefficients from its own w;
the projection stepper under --fast, and the monolithic stepper), and the
Ethier-Steinman cube (its initial state, its Neumann face and a test
forcing: member-independent rhs terms, each member scaled from the
problem's nu).  Both packages run 3 members for 3 steps at float64: equal
per-member F and S counts, u to rtol 1e-8 and p to 1e-7.  The JAX
projection ensemble compiles for about 15 s on a CPU, the monolithic one
for about 5 s.
"""

import pytest

from test_torch_ensemble import assert_same_ensemble, cli_config, ensemble_pair
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)

CASES = {
    "backflow, --fast": ("backflow", cli_config(["ensemble", "--fast"])),
    "backflow, monolithic yosida": ("backflow", cli_config(["ensemble", "--precond", "yosida"])),
    "Ethier-Steinman, monolithic": ("es", cli_config(["convergence"])),
    "Ethier-Steinman, --fast": ("es", cli_config(["convergence", "--fast"])),
}


@pytest.fixture(scope="module")
def runs():
    return {name: ensemble_pair(cfg, geo, nus=(0.5e-3, 1e-3, 2e-3)) for name, (geo, cfg) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_ensemble_problem_terms_match_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_ensemble(jst, jd, tst, td)
    if name.startswith("backflow"):
        assert ts.backflow is not None
    else:
        assert ts.neumann is not None and ts.ftab is not None
