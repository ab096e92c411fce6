"""The PyTorch port's ensemble with the velocity solve's accelerators
against the JAX package's `run_ensemble`: the recycled GCR (f_recycle = 2,
the batched `gcr_recycled` on each member's own pool, a member that has
converged frozen while the others take narrow rounds), the damped
Chebyshev inner solve (f_iters = 3; the set-up F bound is dropped, as the
reference drops it, so each member bounds its F by power iteration), and
the velocity warm-start pool (f_warmstart = 2: the reference's vmapped
step projects it only on the macro path, which it strips, so the pool
rides the state unused and the run equals the run without it).  Both
packages run 3 members for 3 steps at float64 on the small duct under the
ensemble benchmark's configuration (tests/test_torch_ensemble.py): equal
per-member F and S counts, u to rtol 1e-8 and p to 1e-7.  Each JAX
ensemble compiles for about 15 s on a CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_ensemble import assert_same_ensemble, ensemble_config, ensemble_pair
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)

VARIANTS = {
    "f_recycle=2": {"precond": dict(f_recycle=2)},
    "f_iters=3 chebyshev": {"precond": dict(f_iters=3, f_solver="chebyshev", freeze_conv_diag=False)},
    "f_warmstart=2": {"precond": dict(f_warmstart=2)},
}


@pytest.fixture(scope="module")
def runs():
    return {
        name: ensemble_pair(chip_smoke.with_changes(ensemble_config(), ch))
        for name, ch in VARIANTS.items()
    }


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ensemble_velocity_variant_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_ensemble(jst, jd, tst, td)
    if name == "f_recycle=2":
        ref = np.moveaxis(np.asarray(jst.fpool), 0, -1)
        assert tst.fpool.shape == ref.shape and np.abs(ref).max() > 0
        np.testing.assert_allclose(tst.fpool.numpy(), ref, rtol=1e-6, atol=1e-8 * np.abs(ref).max())
    if name == "f_warmstart=2":
        assert torch.count_nonzero(tst.fwpool) == 0 and not np.asarray(jst.fwpool).any()
