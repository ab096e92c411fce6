"""The PyTorch port's monolithic ensemble with the block preconditioners'
inner solvers against the JAX package's `run_ensemble`: the P2 -> P1
velocity correction (its coarse values per member) and the damped
Chebyshev F solve (each member's F bound by power iteration: the
reference's ensemble drops the set-up bound), the SPAI Schur solve (the
set-up values of the base nu serve every member, as under the
reference's vmap), and the Chebyshev and the two-level CG Schur solves.
Both packages run 3 members for 3 steps
at float64 on the small duct under the ensemble CLI's defaults with the
case's flag: equal per-member outer counts, u to rtol 1e-8 and p to 1e-7.
Each JAX ensemble compiles for about 5 s on a CPU.
"""

import pytest

from test_torch_ensemble import assert_same_ensemble, cli_config, ensemble_pair
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)


CASES = {
    "f_solver=pmg": cli_config(["ensemble", "--f-solver", "pmg"]),
    "f_solver=chebyshev": cli_config(["ensemble", "--f-solver", "chebyshev"]),
    "s_solver=spai_cg": cli_config(["ensemble", "--s-solver", "spai_cg"]),
    "s_solver=chebyshev": cli_config(["ensemble", "--s-solver", "chebyshev"]),
    "s_solver=mg2_cg": cli_config(["ensemble", "--s-solver", "mg2_cg"]),
}


@pytest.fixture(scope="module")
def runs():
    return {name: ensemble_pair(cfg) for name, cfg in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_inner_solver_ensemble_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_ensemble(jst, jd, tst, td)
