"""The PyTorch port in 2D against the JAX package: the `cylinder2d` entry
point (the DFG channel, triangles of 6 velocity nodes), `forces_2d`, exact
Poiseuille flow on `rectangle_mesh`, and the `cylinder2d` CLI.

Trajectories: 3 steps at float64 on `cylinder_channel_2d(lc=0.12)` (1,152
DoF), run by both packages under the CLI's defaults (monolithic, asimple)
and under `--fast` (the projection stack on the macro path).  With equal
per-step iteration counts the two differ by summation order only, so u is
held to rtol 1e-8, p to 1e-7, and c_d, c_l and the pressure difference to
1e-8, the standard of tests/test_torch_monolithic.py.

The CLI runs `cylinder2d` in both packages on the same flags at float64
and compares the CSV files (values to rtol 1e-7), loads each side's
final.npz into the other, and runs the port's CLI in a fresh interpreter
in which jax and the JAX package cannot be imported.
"""

import argparse
import csv
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu import cli as jcli
from navierstokes_project_nm4pde_tpu.io import checkpoint as jckpt
from navierstokes_project_nm4pde_tpu.mesh import cylinder_channel_2d as jax_channel
from navierstokes_project_nm4pde_tpu.mesh import rectangle_mesh as jax_rectangle
from navierstokes_project_nm4pde_tpu.models import Cylinder2DProblem as JaxCylinder2D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.ops import functionals as jfn
from navierstokes_project_nm4pde_tpu_torch import cli as tcli
from navierstokes_project_nm4pde_tpu_torch import config as tconfig
from navierstokes_project_nm4pde_tpu_torch.io import checkpoint as tckpt
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_channel_2d, rectangle_mesh
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder2DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.models.base import ProblemSpec
from navierstokes_project_nm4pde_tpu_torch.ops import functionals as tfn
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CHANNEL = dict(lc=0.12)
STEPS = 3


def cylinder2d_config(*flags, dtype="float64"):
    """The port's RunConfig of `cylinder2d` with `flags` (its own parser)."""
    return tcli._build_config(tcli._parser().parse_args(["cylinder2d", *flags, "--dtype", dtype]), None)


RUNS = {"cli defaults": (), "--fast": ("--fast",)}


def run_both(cfg, steps=STEPS):
    js = JaxSolver(jax_channel(**CHANNEL), JaxCylinder2D(test_case=2), jax_config(cfg))
    jst, jd = js.run(steps)
    ts = NavierStokesSolver(cylinder_channel_2d(**CHANNEL), Cylinder2DProblem(test_case=2), cfg, device="cpu")
    tst, td = ts.run(steps)
    return js, jst, jd, ts, tst, td


@pytest.fixture(scope="module")
def runs():
    return {name: run_both(cylinder2d_config(*flags)) for name, flags in RUNS.items()}


def assert_same_run(jst, jd, tst, td):
    for k in ("iters", "iters_f", "iters_s"):
        np.testing.assert_array_equal(getattr(td, k), np.asarray(getattr(jd, k)))
    ju, jp = np.asarray(jst.u), np.asarray(jst.p)
    np.testing.assert_allclose(tst.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(tst.p.numpy(), jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())
    for k in ("c_d", "c_l", "delta_p"):
        np.testing.assert_allclose(getattr(td, k), np.asarray(getattr(jd, k)), rtol=1e-8)


@pytest.mark.parametrize("name", list(RUNS))
def test_cylinder2d_matches_reference(runs, name):
    js, jst, jd, ts, tst, td = runs[name]
    np.testing.assert_array_equal(ts.space.cells_u, js.space.cells_u)
    assert ts.space.cells_u.shape[1] == 6 and tst.u.shape[1] == 2
    assert_same_run(jst, jd, tst, td)
    assert np.all(np.abs(td.c_d) > 0)


def test_cylinder2d_paths(runs):
    """The CLI's defaults run the monolithic stepper on the element passes;
    --fast the projection stepper on the macro blocks (triangles: nloc 6)."""
    mono, fast = runs["cli defaults"][3], runs["--fast"][3]
    assert mono.config.time.stepper == "monolithic" and mono.config.precond.kind == "asimple"
    assert "macro" not in vars(mono)
    assert fast.f_apply == "macro" and fast.macro.lidx.shape[2] == 6


def test_forces_2d_matches_reference(runs):
    """forces_2d (the full stress with the non-symmetric gradient) on seeded
    random fields, a single run's and an ensemble's (members last, own nu)."""
    js, ts = runs["cli defaults"][0], runs["cli defaults"][3]
    rng = np.random.default_rng(3)
    u, p = rng.normal(size=(ts.space.n_unodes, 2)), rng.normal(size=ts.space.n_pnodes)
    ref = jfn.forces_2d(js.forces, jnp.asarray(u), jnp.asarray(p), 1e-3)
    out = tfn.forces_2d(ts.forces, torch.as_tensor(u), torch.as_tensor(p), 1e-3)
    np.testing.assert_allclose([float(v) for v in out], [float(v) for v in ref], rtol=1e-10)
    nus = np.array([1e-3, 5e-2])
    ub, pb = np.stack([u, 2 * u], -1), np.stack([p, -p], -1)
    drag, lift = tfn.forces_2d(ts.forces, torch.as_tensor(ub), torch.as_tensor(pb), torch.as_tensor(nus))
    for m in range(2):
        r = jfn.forces_2d(js.forces, jnp.asarray(ub[..., m]), jnp.asarray(pb[..., m]), nus[m])
        np.testing.assert_allclose([float(drag[m]), float(lift[m])], [float(v) for v in r], rtol=1e-10)


def test_rectangle_mesh_matches_reference():
    for args in ((8, 4), (3, 5)):
        jm, tm = jax_rectangle(*args, lx=2.0), rectangle_mesh(*args, lx=2.0)
        for k in ("coords", "cells", "bface_verts", "bface_tag"):
            np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k))


def test_poiseuille_exact():
    """The P2-P1 discretization reproduces steady Poiseuille flow (parabolic
    velocity, linear pressure) on `rectangle_mesh` to solver tolerance: the
    setting of the reference's tests/test_poiseuille.py, run in the port."""
    H, L, NU, UMAX = 1.0, 2.0, 0.05, 1.0

    def inlet(x, t):
        y = x[:, 1]
        ux = 4.0 * UMAX * y * (H - y) / (H * H)
        return torch.stack([ux, torch.zeros_like(ux)], dim=1)

    problem = ProblemSpec(dim=2, nu=NU, dirichlet={0: inlet, 2: lambda x, t: torch.zeros_like(x)})
    cfg = tconfig.RunConfig(
        time=tconfig.TimeConfig(dt=0.1, t_end=10.0),
        solver=tconfig.SolverConfig(rtol=1e-10, restart=80, maxiter=400),
        precond=tconfig.PrecondConfig(kind="asimple", f_iters=8, s_iters=40),
        numerics=tconfig.NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=10),
    )
    solver = NavierStokesSolver(rectangle_mesh(8, 4, lx=L, ly=H), problem, cfg, device="cpu")
    state, _ = solver.run(100)
    y = solver.space.unode_coords[:, 1]
    u = state.u.numpy()
    assert np.abs(u[:, 0] - 4.0 * UMAX * y * (H - y) / (H * H)).max() < 1e-6
    assert np.abs(u[:, 1]).max() < 1e-6
    slope = np.polyfit(solver.mesh.coords[:, 0], state.p.numpy(), 1)[0]
    expect = -8.0 * NU * UMAX / H**2
    assert abs(slope - expect) / abs(expect) < 1e-4


# ---------------------------------------------------------------------------
# the cylinder2d CLI
# ---------------------------------------------------------------------------
CLI_FLAGS = ["--lc", "0.12", "--n-steps", "4", "--steps-per-chunk", "2", "--dtype", "float64",
             "--output-every", "2", "--checkpoint-every", "2"]
CSV_FILES = ("gmres.csv", "coeff_2.csv", "forces_results_2D_2case.csv")


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Output dirs of the JAX CLI and the port's CLI on CLI_FLAGS (the
    defaults, and --fast --scheme bdf2)."""
    root = tmp_path_factory.mktemp("cli2d")
    d = {}
    for name, extra in (("defaults", []), ("fast bdf2", ["--fast", "--scheme", "bdf2"])):
        d[name] = {k: root / f"{name}-{k}" for k in ("jax", "port")}
        jcli.main(["cylinder2d", *CLI_FLAGS, *extra, "--output-dir", str(d[name]["jax"])])
        tcli.main(["cylinder2d", *CLI_FLAGS, *extra, "--device", "cpu",
                   "--output-dir", str(d[name]["port"])])
    return d


@pytest.mark.parametrize("name", ["defaults", "fast bdf2"])
def test_cylinder2d_cli_writes_the_reference_files(cli_runs, name):
    """The same files, headers and row counts; values to rtol 1e-7 (the
    wall-time columns of the forces file aside); the same summary."""
    out, ref = cli_runs[name]["port"], cli_runs[name]["jax"]
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in out.iterdir()) == names
    assert set(CSV_FILES) <= set(names) and "final.npz" in names and "solution.pvd" in names
    for f in CSV_FILES:
        o, r = _rows(out / f), _rows(ref / f)
        assert len(o) == len(r) and len(r) >= 2
        if f.startswith("forces"):
            assert o[0] == r[0]
            o, r = [row[:5] for row in o[1:]], [row[:5] for row in r[1:]]
        np.testing.assert_allclose(np.asarray(o, float), np.asarray(r, float), rtol=1e-7, atol=1e-12)


def test_cylinder2d_checkpoints_load_into_both_packages(cli_runs):
    """Each package's final.npz loads into the other with the same keys and
    arrays (BDF2's history included)."""
    d = cli_runs["fast bdf2"]
    with np.load(d["port"] / "final.npz") as zp, np.load(d["jax"] / "final.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
    t_from_j = tckpt.load_checkpoint(str(d["jax"] / "final.npz"), dtype=torch.float64, device="cpu")
    j_from_t = jckpt.load_checkpoint(str(d["port"] / "final.npz"), dtype=jnp.float64)
    assert t_from_j.step == 4 and int(j_from_t.step) == 4
    for k in ("u", "p", "u_prev", "p_prev", "u_prev2"):
        np.testing.assert_allclose(getattr(t_from_j, k).numpy(), np.asarray(getattr(j_from_t, k)),
                                   rtol=1e-8, atol=1e-10)


def test_cylinder2d_cli_parser_matches_reference():
    """The port's cylinder2d and convergence subcommands take the
    reference's flags with the same defaults (and --device)."""
    jp = argparse.ArgumentParser()
    jsub = jp.add_subparsers(dest="cmd")
    for name, kw in (("cylinder2d", dict(dt=0.01, t_end=8.0, precond="asimple")),
                     ("convergence", dict(dt=4e-4, t_end=4e-4, precond="asimple"))):
        jcli._common_flags(jsub.add_parser(name), **kw)
    for name in ("cylinder2d", "convergence"):
        ta = vars(tcli._parser().parse_args([name]))
        ref = vars(jp.parse_args([name]))
        assert ta.pop("device") == "cuda"
        assert {k: ta[k] for k in ref} == ref
    assert vars(tcli._parser().parse_args(["convergence"]))["levels"] == [2, 4, 8, 16]
    assert vars(tcli._parser().parse_args(["convergence"]))["dtype"] == "float32"
    assert vars(tcli._parser().parse_args(["cylinder2d"]))["lc"] == 0.05


def test_cylinder2d_and_convergence_cli_run_without_jax(tmp_path):
    """The port's cylinder2d and convergence CLIs at float32 in a fresh
    interpreter in which neither jax nor the JAX package can be imported."""
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

        main(["cylinder2d", "--lc", "0.12", "--n-steps", "2", "--steps-per-chunk", "1",
              "--device", "cpu", "--output-dir", sys.argv[2] + "/c2d"])
        main(["convergence", "--levels", "2", "4", "--device", "cpu",
              "--output-dir", sys.argv[2] + "/conv"])
        assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
        print("OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code, str(REPO), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK"), res.stdout
    assert len(_rows(tmp_path / "c2d" / "gmres.csv")) == 2
    assert (tmp_path / "c2d" / "forces_results_2D_2case.csv").exists()
    rows = _rows(tmp_path / "conv" / "convergence.csv")
    assert rows[0] == ["h", "eL2", "eH1"] and len(rows) == 3


@pytest.mark.parametrize("cmd", [["cylinder2d", "--lc", "0.12"], ["convergence", "--levels", "2"]])
def test_new_entry_points_need_a_card_unless_told_cpu(tmp_path, cmd):
    """The cylinder2d and convergence CLIs default to the card: without one
    they stop with a message and write nothing; so does a table builder
    given no device."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli.main([*cmd, "--n-steps", "1", "--output-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    ts = NavierStokesSolver(cylinder_channel_2d(**CHANNEL), Cylinder2DProblem(), cylinder2d_config(),
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfn.build_error_tables(ts.space, ts.geom)
