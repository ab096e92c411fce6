"""The PyTorch port's ensemble under the monolithic saddle-point stepper
against the JAX package's `run_ensemble`.

The JAX `ensemble` CLI's defaults take the monolithic stepper with asimple
(tests/test_parallel.py:164 runs the same stepper on the 2D channel); the
reference vmaps `_step_dispatch` whole, each member folding its own F_e,
building its own block preconditioner state (asimple: S~ and its coarse
factor per member; yosida: one S~ for every member; block_triangular:
the nu-scaled pressure mass) and
running its own FGMRES.  Both packages run 3 members (nu 1e-3, 2e-3,
5e-3) for 3 steps at float64: the 2D channel under
tests/test_parallel.py's configuration, and the small duct under the
ensemble CLI's defaults, yosida, block_triangular and BDF2.  Equal per-member
outer counts, u to rtol 1e-8 and p to 1e-7; member 1 of the channel run
equals the single run with nu = 2e-3 (the JAX test's check).  Each JAX
ensemble compiles for about 5 s on a CPU.
"""

import numpy as np
import pytest

import chip_smoke
from navierstokes_project_nm4pde_tpu_torch.config import (
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_channel_2d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder2DProblem, NavierStokesSolver
from test_torch_ensemble import assert_same_ensemble, cli_config, ensemble_pair
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)


def parallel_config():
    """tests/test_parallel.py:42 make_config at the ensemble test's dt."""
    return RunConfig(
        time=TimeConfig(dt=0.01, t_end=0.05),
        solver=SolverConfig(rtol=1e-8, restart=40, maxiter=100),
        precond=PrecondConfig(kind="asimple", f_iters=5, s_iters=25),
        numerics=NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=1),
    )


CASES = {
    "channel, tests/test_parallel.py": ("channel", parallel_config()),
    "ensemble CLI defaults (asimple)": ("duct", cli_config(["ensemble"])),
    "yosida": ("duct", cli_config(["ensemble", "--precond", "yosida"])),
    "block_triangular": ("duct", cli_config(["ensemble", "--precond", "block_triangular", "--maxiter", "40"])),
    "bdf2": ("duct", cli_config(["ensemble", "--scheme", "bdf2"])),
}


@pytest.fixture(scope="module")
def runs():
    return {name: ensemble_pair(cfg, geo) for name, (geo, cfg) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_monolithic_ensemble_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert ts.config.time.stepper == "monolithic"
    assert_same_ensemble(jst, jd, tst, td)
    assert np.all(td.iters_s == 0)


def test_monolithic_ensemble_member_equals_the_single_run(runs):
    _, _, _, tst, td = runs["channel, tests/test_parallel.py"]
    single = NavierStokesSolver(cylinder_channel_2d(lc=0.1), Cylinder2DProblem(test_case=2, nu=2e-3),
                                parallel_config(), device="cpu")
    st, d = single.run(3)
    np.testing.assert_array_equal(d.iters, td.iters[1])
    u = tst.u[..., 1].numpy()
    np.testing.assert_allclose(st.u.numpy(), u, rtol=1e-8, atol=1e-10 * np.abs(u).max())
    assert not np.allclose(tst.u[..., 0].numpy(), tst.u[..., 2].numpy())


def test_ensemble_cli_defaults_are_monolithic_asimple():
    cfg = cli_config(["ensemble"])
    assert (cfg.time.stepper, cfg.precond.kind, cfg.solver.restart, cfg.solver.maxiter) == (
        "monolithic", "asimple", 50, 200)
    assert (cfg.precond.f_iters, cfg.precond.s_iters, cfg.solver.tol_mode) == (6, 30, "r0")
    assert chip_smoke.ENSEMBLE_CLI_MESH == dict(lc=0.08, nz=4)
