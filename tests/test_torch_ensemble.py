"""The PyTorch port's Reynolds-sweep ensemble against the JAX package.

Kernels: the plain versions of the port's slot reduce and slot gather
(kernels C and D) against the JAX one-hot Pallas kernels, run in interpret
mode as tests/test_onehot.py runs them, on seeded float32 payloads.  The
JAX kernels accumulate in float32 (and on the TPU split the payload into
bf16 hi/lo parts), while the port sums in the payload's dtype in another
order: the reduce is held to 1e-6 of max |ref| (measured 2.2e-7), the
gather, a copy, exactly.

Trajectories: both packages run `run_ensemble` at float64 on a small DFG
duct, B = 3 over Re 20-300, 3 steps, with the ensemble benchmark's
configuration (scripts/bench_ensemble.py: projection, Jacobi FGMRES
restart 8 / maxiter 25, tol_mode "b", quadratic warm start, frozen
banded Schur with plain CG, s_recycle 0).  With `ensemble_onehot=False`
the JAX reductions are exact in float64 too, so the per-member F and S
counts must be equal, u within rtol 1e-8 and p within 1e-7 (the
tolerances of tests/test_torch_slice.py), c_d, c_l and delta_p within
1e-8.  The comparison with the JAX Pallas path (`ensemble_onehot=True`)
and the state carry-over from a JAX run are in
tests/test_torch_ensemble_onehot.py and tests/test_torch_ensemble_carry.py:
each JAX ensemble run compiles for about 15 s on a CPU, and files of
their own keep each file well inside a minute.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.ops.onehot import build_onehot_plans as jax_plans
from navierstokes_project_nm4pde_tpu.ops.onehot import onehot_gather as jax_gather
from navierstokes_project_nm4pde_tpu.ops.onehot import onehot_reduce as jax_reduce
from navierstokes_project_nm4pde_tpu.parallel import run_ensemble as jax_run_ensemble
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu_torch.ops import onehot as toh
from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble
from test_torch_port_copies import jax_config

REPO = Path(__file__).resolve().parent.parent
STEPS = 3


def ensemble_config(dtype="float64", onehot=False):
    """The configuration chip_smoke.py's ensemble runs (scripts/
    bench_ensemble.py:47-61), at a test dtype, one step per chunk."""
    cfg = chip_smoke.ensemble_config(dtype)
    return dataclasses.replace(cfg, numerics=dataclasses.replace(
        cfg.numerics, steps_per_chunk=1, ensemble_onehot=onehot,
    ))


def sweep_nus(problem, B=3):
    return chip_smoke.sweep_nus(problem, B)


def _members_last(x):
    return np.moveaxis(np.asarray(x), 0, -1)


# ----------------------------------------------------------------------
# Kernels C and D (plain versions) against the JAX one-hot kernels
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def rcm_duct():
    """The JAX package's element table; the port's plans are built on the
    same numpy array."""
    mesh = jax_duct(lc=0.12, nz=4).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    cells = np.asarray(space.cells_u)
    return (
        cells, space.n_unodes,
        jax_plans(cells, mesh.n_vertices, space.n_unodes),
        toh.build_onehot_plans(cells, space.n_unodes, device="cpu"),
    )


@pytest.mark.parametrize("C", [12, 192])
def test_slot_kernels_plain_match_jax_onehot_kernels(rcm_duct, C):
    cells, n_u, jplans, tplans = rcm_duct
    rng = np.random.default_rng(C)
    y = rng.standard_normal((cells.size, C)).astype(np.float32)
    x = rng.standard_normal((n_u, C)).astype(np.float32)

    ref = np.asarray(jax_reduce(jplans, jnp.asarray(y), precise=True))
    out = toh.onehot_reduce(tplans, torch.as_tensor(y)).numpy()
    assert out.shape == ref.shape == (n_u, C)
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()

    ref_g = np.asarray(jax_gather(jplans, jnp.asarray(x)))
    out_g = toh.onehot_gather(tplans, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(out_g, ref_g)


def test_slot_reduce_plain_is_exact_in_float64(rcm_duct):
    cells, n_u, _, tplans = rcm_duct
    y = np.random.default_rng(7).standard_normal((cells.size, 5))
    ref = np.zeros((n_u, 5))
    np.add.at(ref, cells.reshape(-1), y)
    out = toh.onehot_reduce(tplans, torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-14, atol=1e-14)
    with pytest.raises(ValueError):
        toh.build_onehot_plans(cells, int(cells.max()), device="cpu")  # a row past n_rows


# ----------------------------------------------------------------------
# The ensemble against the JAX run_ensemble
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs():
    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    jp = JaxCylinder3D(test_case=2)
    nus = sweep_nus(jp)
    js = JaxSolver(jax_duct(lc=0.22, nz=3), jp, jax_config(ensemble_config()))
    jst3, jd3 = jax_run_ensemble(js, nus, STEPS)
    ts = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), ensemble_config(), device="cpu")
    tst, td = run_ensemble(ts, nus, STEPS)
    return dict(
        mesh=mesh, nus=nus, jst3=jst3, jd3=jd3, ts=ts, tst=tst, td=td,
    )


def test_ensemble_matches_reference_iteration_counts(runs):
    td, jd = runs["td"], runs["jd3"]
    assert td.iters_f.shape == (3, STEPS)
    np.testing.assert_array_equal(td.iters_f, np.asarray(jd.iters_f))
    np.testing.assert_array_equal(td.iters_s, np.asarray(jd.iters_s))
    assert np.all(td.iters_f < 25) and np.all(td.iters_s < 25)


def test_ensemble_matches_reference_state(runs):
    st, js = runs["tst"], runs["jst3"]
    ju, jp = _members_last(js.u), _members_last(js.p)
    np.testing.assert_allclose(st.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(st.p.numpy(), jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())
    assert st.step == STEPS
    # members really differ (each runs its own nu)
    assert not np.allclose(ju[..., 0], ju[..., 2])


@pytest.mark.parametrize("key", ["c_d", "c_l", "delta_p"])
def test_ensemble_matches_reference_functionals(runs, key):
    np.testing.assert_allclose(
        getattr(runs["td"], key), np.asarray(getattr(runs["jd3"], key)), rtol=1e-8, atol=0.0
    )


def test_ensemble_member_equals_single_run(runs):
    """Member m of the ensemble is the single run with nu_m (macro path,
    plain CG: another summation order, the same counts)."""
    m = 1
    cfg = ensemble_config()
    single = NavierStokesSolver(
        runs["mesh"], Cylinder3DProblem(test_case=2, nu=float(runs["nus"][m])), cfg,
        device="cpu",
    )
    st, d = single.run(STEPS)
    np.testing.assert_array_equal(d.iters_f, runs["td"].iters_f[m])
    np.testing.assert_array_equal(d.iters_s, runs["td"].iters_s[m])
    u = runs["tst"].u[..., m].numpy()
    np.testing.assert_allclose(st.u.numpy(), u, rtol=1e-8, atol=1e-10 * np.abs(u).max())
    np.testing.assert_allclose(d.c_d, runs["td"].c_d[m], rtol=1e-8)


def test_ensemble_cli_runs_without_jax(tmp_path):
    """The port's `cli.py ensemble` (and so run_ensemble) in a fresh
    interpreter in which neither jax nor the JAX package can be imported;
    it writes ensemble.csv with the reference's header."""
    code = textwrap.dedent(
        """
        import sys

        BLOCKED = ("jax", "jaxlib", "navierstokes_project_nm4pde_tpu")

        class _NoJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked in this process")
                return None

        for k in [k for k in sys.modules if k.split(".")[0] in BLOCKED]:
            del sys.modules[k]
        sys.meta_path.insert(0, _NoJax())
        sys.path.insert(0, sys.argv[1])
        from navierstokes_project_nm4pde_tpu_torch.cli import main

        main(["ensemble", "--fast", "--onehot", "--n-members", "2", "--lc", "0.25",
              "--nz", "3", "--dt", "2e-4", "--maxiter", "25", "--n-steps", "2",
              "--device", "cpu", "--output-dir", sys.argv[2]])
        assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
        print("OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code, str(REPO), str(tmp_path)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.rstrip().endswith("OK"), res.stdout
    lines = (tmp_path / "ensemble.csv").read_text().splitlines()
    assert lines[0] == "Re,nu,cd_max,cl_min,delta_p_final"
    assert len(lines) == 3
    vals = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    assert np.all(np.isfinite(vals)) and vals[0, 0] == 20.0 and vals[1, 0] == 300.0


def test_ensemble_cli_refuses_what_is_not_ported(tmp_path):
    from navierstokes_project_nm4pde_tpu_torch.cli import main

    for argv in (["cylinder3d"], ["ensemble", "--fast", "--dim", "2"]):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--output-dir", str(tmp_path)] if argv[0] == "ensemble" else argv)
        assert "PyTorch port" in str(exc.value)


def test_ensemble_cli_needs_a_card_unless_told_cpu(tmp_path):
    """The CLI's default device is cuda; without a card it stops with a
    message instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    from navierstokes_project_nm4pde_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main(["ensemble", "--fast", "--n-members", "2", "--lc", "0.25", "--nz", "3",
              "--n-steps", "1", "--output-dir", str(tmp_path)])
    assert "CUDA is not available" in str(exc.value)
    assert not (tmp_path / "ensemble.csv").exists()


@pytest.mark.parametrize("path", ["single", "ensemble"])
def test_solver_builds_only_its_paths_structures(runs, path):
    """The macro-block plan and macro mass belong to the single run's step,
    the element-slot plans to the ensemble's: each is built at first use,
    so a solver never holds the other path's."""
    if path == "ensemble":
        solver = runs["ts"]  # has run the ensemble
    else:
        solver = NavierStokesSolver(
            runs["mesh"], Cylinder3DProblem(test_case=2), ensemble_config(), device="cpu"
        )
        solver.run(1)
    built = {k for k in ("macro", "macro_mass") if k in vars(solver)}
    built |= {"onehot"} & set(vars(solver.op))
    assert built == ({"macro", "macro_mass"} if path == "single" else {"onehot"})


def test_ensemble_rejects_recycled_pressure_pool(runs):
    cfg = ensemble_config()
    cfg = dataclasses.replace(cfg, precond=dataclasses.replace(cfg.precond, s_recycle=1))
    ts = NavierStokesSolver(runs["mesh"], Cylinder3DProblem(), cfg, device="cpu")
    with pytest.raises(ValueError):
        run_ensemble(ts, runs["nus"], 1)
