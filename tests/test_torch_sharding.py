"""The PyTorch port's cell-sharded runs and multi-rank entry points, on local
CPU ranks under torch.distributed (gloo).

  * `shard_operator`: the saddle-point operator with each rank's block of
    the cells and the all-reduced node reduces equals the unsharded one to
    1e-12 (tests/test_parallel.py:57's setting), on 2 and 4 ranks;
  * `shard_solver` runs match the unsharded port at tests/test_parallel.py's
    two configurations (the monolithic step on the Ethier-Steinman cube,
    and the projection stack on the small duct), with equal counts and
    that file's tolerances, on 2 and 4 ranks; `cell_partitioning` equals
    the JAX package's;
  * `cylinder3d --shard-cells 2` writes the JAX CLI's files (its CSV logs
    to rtol 1e-7, its .pvtu records with the same `partitioning` field);
  * `ensemble --shard-batch` on 2 ranks gathers every member's row of
    ensemble.csv, equal to the one-rank run's;
  * in a fresh interpreter with jax and the JAX package blocked, the
    `ensemble` CLI at its defaults and `cylinder3d --shard-cells 2` run, and
    no rank imported either.

Each launch spawns fresh interpreters (a few seconds each); the launches
are shared through module-scoped fixtures, and every launch has a
timeout.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu import cli as jcli
from navierstokes_project_nm4pde_tpu.mesh import cube_mesh as jax_cube
from navierstokes_project_nm4pde_tpu.models import EthierSteinmanProblem as JaxES
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.parallel import cell_partitioning as jax_cell_partitioning
from navierstokes_project_nm4pde_tpu.parallel import make_device_mesh as jax_device_mesh
from navierstokes_project_nm4pde_tpu.parallel import shard_solver as jax_shard_solver
from navierstokes_project_nm4pde_tpu_torch import cli as tcli
from navierstokes_project_nm4pde_tpu_torch.config import (
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from navierstokes_project_nm4pde_tpu_torch.mesh import cube_mesh, cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder3DProblem,
    EthierSteinmanProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
from navierstokes_project_nm4pde_tpu_torch.parallel import (
    cell_partitioning,
    launch,
    make_device_mesh,
    shard_solver,
)
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300  # seconds a collective may wait before its rank raises
BLOCKED = ("jax", "jaxlib", "navierstokes_project_nm4pde_tpu")


def parallel_config(**kw):
    """tests/test_parallel.py:42 make_config."""
    defaults = dict(
        time=TimeConfig(dt=0.01, t_end=1.0),
        solver=SolverConfig(rtol=1e-8, restart=40, maxiter=100),
        precond=PrecondConfig(kind="asimple", f_iters=5, s_iters=25),
        numerics=NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=2),
    )
    defaults.update(kw)
    return RunConfig(**defaults)


def projection_config():
    """tests/test_parallel.py:101's projection stack."""
    return parallel_config(
        time=TimeConfig(dt=1e-3, t_end=1.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-10, restart=8, maxiter=80, tol_mode="b", guess_order=2),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3, mg2_form="additive"),
        numerics=NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=2,
                                proj_schur="frozen", schur_spmv="auto", reduce_plan="columns"),
    )


# name -> (mesh, problem, config, steps, (u rtol, u atol), (p rtol, p atol))
RUNS = {
    "monolithic, Ethier-Steinman": (
        lambda: cube_mesh(2), EthierSteinmanProblem, lambda: parallel_config(time=TimeConfig(dt=4e-4, t_end=4e-4)),
        1, (1e-9, 1e-11), (1e-8, 1e-9)),
    "projection, small duct": (
        lambda: cylinder_duct_3d(lc=0.3, nz=3), lambda: Cylinder3DProblem(test_case=2), projection_config,
        2, (1e-8, 1e-10), (1e-7, 1e-9)),
}


def _sharded_rank(rank, world, device):
    """Every rank: the sharded apply_system, each RUNS case's sharded run and
    the cell partitioning."""
    group = make_device_mesh()
    solver = NavierStokesSolver(cube_mesh(2), EthierSteinmanProblem(), parallel_config(), device=device)
    u, p = apply_inputs(solver)
    shard_solver(solver, group)
    out = {"apply": [y.numpy() for y in ops.apply_system(solver.op, 0.01, 0.01, None, u, p)]}
    for name, (mesh, problem, cfg, steps, _, _) in RUNS.items():
        s = shard_solver(NavierStokesSolver(mesh(), problem(), cfg(), device=device), group)
        st, d = s.run(steps)
        out[name] = dict(u=st.u.numpy(), p=st.p.numpy(), iters=d.iters.tolist(),
                         partitioning=cell_partitioning(s, group))
    return out


def apply_inputs(solver):
    rng = np.random.default_rng(0)
    return (torch.as_tensor(rng.normal(size=(solver.space.n_unodes, 3))),
            torch.as_tensor(rng.normal(size=solver.space.n_pnodes)))


@pytest.fixture(scope="module")
def sharded():
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    return {n: launch(_sharded_rank, n, device="cpu", timeout=TIMEOUT) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_operator_matches_single_device(sharded, n):
    solver = NavierStokesSolver(cube_mesh(2), EthierSteinmanProblem(), parallel_config(), device="cpu")
    ref = ops.apply_system(solver.op, 0.01, 0.01, None, *apply_inputs(solver))
    for r in sharded[n]:
        for out, y in zip(r["apply"], ref):
            np.testing.assert_allclose(out, y.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_run_matches_unsharded(sharded, n, name):
    mesh, problem, cfg, steps, (urt, uat), (prt, pat) = RUNS[name]
    st, d = NavierStokesSolver(mesh(), problem(), cfg(), device="cpu").run(steps)
    for r in sharded[n]:  # every rank holds the same run
        out = r[name]
        assert out["iters"] == d.iters.tolist()
        np.testing.assert_allclose(out["u"], st.u.numpy(), rtol=urt, atol=uat)
        np.testing.assert_allclose(out["p"], st.p.numpy(), rtol=prt, atol=pat)


@pytest.mark.parametrize("n", [2, 4])
def test_cell_partitioning_equals_reference(sharded, n):
    js = JaxSolver(jax_cube(2), JaxES(), jax_config(parallel_config()))
    dmesh = jax_device_mesh(n)
    jax_shard_solver(js, dmesh)
    ref = jax_cell_partitioning(js, dmesh)
    out = sharded[n][0]["monolithic, Ethier-Steinman"]["partitioning"]
    np.testing.assert_array_equal(out, ref)
    assert set(out.tolist()) == set(range(n))


# ----------------------------------------------------------------------
# the entry points
# ----------------------------------------------------------------------
def _rows(path):
    return [ln.split(",") for ln in Path(path).read_text().splitlines()]


def _partitioning(path):
    text = Path(path).read_text()
    return re.search(r'Name="partitioning" format="binary">([^<]*)<', text).group(1)


def test_shard_cells_cli_writes_the_reference_files(tmp_path):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    flags = ["cylinder3d", "--lc", "0.25", "--nz", "3", "--n-steps", "3", "--steps-per-chunk", "1",
             "--dtype", "float64", "--output-every", "2", "--shard-cells", "2"]
    jcli.main([*flags, "--output-dir", str(tmp_path / "jax")])
    tcli.main([*flags, "--device", "cpu", "--output-dir", str(tmp_path / "port")])
    out, ref = tmp_path / "port", tmp_path / "jax"
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in out.iterdir()) == names
    assert "solution_000002.pvtu" in names and "solution_000002_0001.vtu" in names
    for name in ("gmres.csv", "coeff_2.csv", "forces_results_3D_2case.csv"):
        o, r = _rows(out / name), _rows(ref / name)
        assert len(o) == len(r) >= 3
        if name.startswith("forces"):
            assert o[0] == r[0]
            o, r = [row[:5] for row in o[1:]], [row[:5] for row in r[1:]]
        np.testing.assert_allclose(np.asarray(o, float), np.asarray(r, float), rtol=1e-7, atol=1e-12)
    for piece in ("solution_000002_0000.vtu", "solution_000003_0001.vtu"):
        assert _partitioning(out / piece) == _partitioning(ref / piece)
    assert (out / "solution_000003.pvtu").read_text() == (ref / "solution_000003.pvtu").read_text()


def test_shard_batch_gathers_every_member(tmp_path):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    flags = ["ensemble", "--fast", "--n-members", "4", "--lc", "0.25", "--nz", "3", "--dt", "2e-4",
             "--n-steps", "2", "--steps-per-chunk", "1", "--dtype", "float64", "--device", "cpu"]
    tcli.main([*flags, "--output-dir", str(tmp_path / "one")])
    args = tcli._parser().parse_args([*flags, "--shard-batch", "--output-dir", str(tmp_path / "two")])
    launch(tcli._ensemble_rank, 2, args, device="cpu", timeout=TIMEOUT)
    one, two = _rows(tmp_path / "one" / "ensemble.csv"), _rows(tmp_path / "two" / "ensemble.csv")
    assert two[0] == one[0] == ["Re", "nu", "cd_max", "cl_min", "delta_p_final"] and len(two) == 5
    np.testing.assert_allclose(np.asarray(two[1:], float), np.asarray(one[1:], float), rtol=1e-8)
    assert tcli._batch_ranks(4, torch.device("cpu")) == 1  # the reference's rule on no card


def test_multi_rank_cli_runs_without_jax(tmp_path):
    """The `ensemble` CLI at its defaults (monolithic, asimple; a tiny duct,
    2 members, 2 steps) and `cylinder3d --shard-cells 2` in a fresh
    interpreter with jax and the JAX package blocked; neither the
    interpreter nor any rank it launched imported them."""
    code = textwrap.dedent(
        f"""
        import sys

        BLOCKED = {BLOCKED!r}

        class _NoJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked in this process")
                return None

        for k in [k for k in sys.modules if k.split(".")[0] in BLOCKED]:
            del sys.modules[k]
        sys.meta_path.insert(0, _NoJax())
        sys.path.insert(0, sys.argv[1])
        from navierstokes_project_nm4pde_tpu_torch.cli import main
        from navierstokes_project_nm4pde_tpu_torch.parallel.launch import last_launch

        small = ["--lc", "0.25", "--nz", "3", "--n-steps", "2", "--steps-per-chunk", "1", "--device", "cpu"]
        main(["ensemble", "--n-members", "2", *small, "--output-dir", sys.argv[2] + "/ens"])
        main(["cylinder3d", "--shard-cells", "2", *small, "--output-dir", sys.argv[2] + "/c3d"])
        assert len(last_launch["modules"]) == 2, last_launch
        for mods in last_launch["modules"]:
            assert not set(mods) & set(BLOCKED), mods
        assert all(r["kernel_launches"]["slot_reduce"] == 0 for r in last_launch["results"])  # the CPU
        assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
        print("OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code, str(REPO), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.rstrip().endswith("OK"), res.stdout
    assert "Sharded cells over 2 ranks (torch.distributed, gloo)" in res.stdout
    assert len(_rows(tmp_path / "ens" / "ensemble.csv")) == 3
    assert (tmp_path / "c3d" / "final.npz").exists() and len(_rows(tmp_path / "c3d" / "gmres.csv")) == 2
