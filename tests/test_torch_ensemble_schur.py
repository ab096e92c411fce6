"""The PyTorch port's ensemble on the other Schur paths against the JAX
package's `run_ensemble`: the recycled frozen-Schur pool (s_recycle = 2,
one pool a member riding the ensemble state with a trailing member axis,
the batched `cg_recycled`), the step's assembled S~ (proj_schur "step":
yosida's S~ does not depend on nu, so one S~ and coarse factor serve every
member) and the frozen S1's ELL SpMV (schur_spmv "ell").  Both packages
run 3 members for 3 steps at float64 on the small duct under the
ensemble benchmark's configuration (tests/test_torch_ensemble.py): equal
per-member F and S counts, u to rtol 1e-8 and p to 1e-7, and the pools
to the same tolerance as p.  Each JAX ensemble compiles for about 15 s on
a CPU.
"""

import numpy as np
import pytest

import chip_smoke
from test_torch_ensemble import assert_same_ensemble, ensemble_config, ensemble_pair
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)

VARIANTS = {
    "s_recycle=2": {"precond": dict(s_recycle=2)},
    "proj_schur=step": {"numerics": dict(proj_schur="step")},
    "schur_spmv=ell": {"numerics": dict(schur_spmv="ell")},
}


@pytest.fixture(scope="module")
def runs():
    return {
        name: ensemble_pair(chip_smoke.with_changes(ensemble_config(), ch))
        for name, ch in VARIANTS.items()
    }


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ensemble_schur_path_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_ensemble(jst, jd, tst, td)
    if name == "s_recycle=2":
        ref = np.moveaxis(np.asarray(jst.spool), 0, -1)
        assert tst.spool.shape == ref.shape == (2, 2, ts.space.n_pnodes, 3)
        np.testing.assert_allclose(tst.spool.numpy(), ref, rtol=1e-7, atol=1e-9 * np.abs(ref).max())
    if name == "schur_spmv=ell":
        assert ts.proj_schur.band is None
