"""The PyTorch port's monolithic stepper, its chunked run, the projection
paths on the per-step and frozen ELL Schur, and the `cylinder3d` CLI,
against the JAX package.

Trajectories: 3 steps at float64 on the small DFG duct
`cylinder_duct_3d(lc=0.25, nz=3)`, run by both packages.  With equal
per-step outer (monolithic) or F and S (projection) iteration counts the
two differ by summation order only, so u and p are held to rtol 1e-8 /
1e-7, the standard of tests/test_torch_projection_variants.py.

  * monolithic: the `cylinder3d` CLI's configuration (yosida, f_iters 6,
    s_iters 30, restart 50, maxiter 200, tol_mode r0, precise dots),
    `asimple` and `ayosida`, run in chunks of 2 steps with a callback;
  * projection (chip_smoke.bench_config): proj_schur="step" with the ELL
    gradient, f_iters=4 (the inner fixed GMRES as the F preconditioner),
    schur_spmv="ell", and the frozen ELL fallback when the band is too
    wide, forced in both packages through a small `max_bytes` on
    `build_banded_schur`.

The CLI runs `cylinder3d` in both packages on the same flags at float64
and compares the CSV files (names, headers, rows, values to rtol 1e-7),
loads each side's `final.npz` into the other and resumes from it, and
runs the port's CLI in a fresh interpreter in which jax and the JAX
package cannot be imported.
"""

import contextlib
import csv
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu import cli as jcli
from navierstokes_project_nm4pde_tpu.io import checkpoint as jckpt
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.ops import banded as jbanded
from navierstokes_project_nm4pde_tpu_torch import cli as tcli
from navierstokes_project_nm4pde_tpu_torch import config as tconfig
from navierstokes_project_nm4pde_tpu_torch.io import checkpoint as tckpt
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.models import base as tbase
from navierstokes_project_nm4pde_tpu_torch.ops import banded as tbanded
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
DUCT = dict(lc=0.25, nz=3)
STEPS = 3
CHUNK = 2


def cli_config(dtype="float64", **precond):
    """The RunConfig of `cylinder3d` with no flags (JAX cli.py:67-91,
    :482-485) at `dtype`, in chunks of CHUNK steps."""
    pc = {"kind": "yosida", "f_iters": 6, "s_iters": 30, **precond}
    return tconfig.RunConfig(
        time=tconfig.TimeConfig(dt=2e-4, t_end=4.0),
        precond=tconfig.PrecondConfig(**pc),
        numerics=tconfig.NumericsConfig(dtype=dtype, steps_per_chunk=CHUNK),
    )


MONOLITHIC = {
    "cylinder3d cli": cli_config(),
    "asimple": cli_config(kind="asimple"),
    "ayosida": cli_config(kind="ayosida"),
}
PROJECTION = {
    "proj_schur=step": {"numerics": dict(proj_schur="step", schur_spmv="ell", grad_apply="ell")},
    "f_iters=4": {"precond": dict(f_iters=4)},
    "schur_spmv=ell": {"numerics": dict(schur_spmv="ell")},
    "frozen ELL fallback": {},
}


def projection_config(changes):
    changes = {**changes, "numerics": {"steps_per_chunk": 1, **changes.get("numerics", {})}}
    return chip_smoke.with_changes(chip_smoke.bench_config("float64"), changes)


@contextlib.contextmanager
def no_band():
    """Both packages' `build_banded_schur` with a 1-byte limit: every band
    is too wide, so the frozen S1 runs its ELL SpMV."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbanded, "build_banded_schur", functools.partial(jbanded.build_banded_schur, max_bytes=1))
        mp.setattr(tbase, "build_banded_schur", functools.partial(tbanded.build_banded_schur, max_bytes=1))
        yield


def run_both(cfg, steps=STEPS):
    """(JAX state, JAX diags, JAX chunks, port solver, port state, port
    diags, port chunks): `steps` steps from rest, each side's callback
    recording (steps in the chunk, the chunk's diagnostics)."""
    jchunks, tchunks = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ayosida's maxiter warning, on both sides
        js = JaxSolver(jax_duct(**DUCT), JaxCylinder3D(test_case=2), jax_config(cfg))
        jst, jd = js.run(steps, callback=lambda s, st, d: jchunks.append(d))
        ts = NavierStokesSolver(cylinder_duct_3d(**DUCT), Cylinder3DProblem(test_case=2), cfg, device="cpu")
        tst, td = ts.run(steps, callback=lambda s, st, d: tchunks.append(d))
    return jst, jd, jchunks, ts, tst, td, tchunks


@pytest.fixture(scope="module")
def runs():
    out = {name: run_both(cfg) for name, cfg in MONOLITHIC.items()}
    for name, changes in PROJECTION.items():
        with no_band() if name == "frozen ELL fallback" else contextlib.nullcontext():
            out[name] = run_both(projection_config(changes))
    return out


def assert_same_run(jst, jd, tst, td):
    np.testing.assert_array_equal(td.iters, np.asarray(jd.iters))
    np.testing.assert_array_equal(td.iters_f, np.asarray(jd.iters_f))
    np.testing.assert_array_equal(td.iters_s, np.asarray(jd.iters_s))
    ju, jp = np.asarray(jst.u), np.asarray(jst.p)
    np.testing.assert_allclose(tst.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(tst.p.numpy(), jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())
    np.testing.assert_allclose(td.c_d, np.asarray(jd.c_d), rtol=1e-8)
    np.testing.assert_allclose(td.delta_p, np.asarray(jd.delta_p), rtol=1e-8)


@pytest.mark.parametrize("name", list(MONOLITHIC))
def test_monolithic_matches_reference(runs, name):
    jst, jd, _, ts, tst, td, _ = runs[name]
    assert ts.config.time.stepper == "monolithic"
    assert_same_run(jst, jd, tst, td)
    assert np.all(td.iters_s == 0)


@pytest.mark.parametrize("name", list(PROJECTION))
def test_projection_schur_paths_match_reference(runs, name):
    jst, jd, _, ts, tst, td, _ = runs[name]
    assert_same_run(jst, jd, tst, td)


def test_paths_take_their_schur(runs):
    """proj_schur="step" assembles S~ every step (no frozen S1); "ell" and
    the fallback run the frozen S1's ELL SpMV (no band); the monolithic
    stepper builds no frozen Schur, band or macro plan."""
    assert runs["proj_schur=step"][3].proj_schur is None
    assert runs["proj_schur=step"][3].op.schur.prod_vals is not None
    for name in ("schur_spmv=ell", "frozen ELL fallback"):
        fz = runs[name][3].proj_schur
        assert fz.band is None and fz.vals1 is not None
    assert runs["f_iters=4"][3].proj_schur.band is not None
    mono = runs["cylinder3d cli"][3]
    assert mono.proj_schur is None and "macro" not in vars(mono)
    assert mono.op.div is None and mono.op.grad is None


def test_banded_schur_refuses_a_band_too_wide():
    """schur_spmv="banded" names the fault instead of falling back."""
    cfg = projection_config({"numerics": dict(schur_spmv="banded")})
    with no_band(), pytest.raises(ValueError, match="band is too wide"):
        NavierStokesSolver(cylinder_duct_3d(**DUCT), Cylinder3DProblem(test_case=2), cfg, device="cpu")


@pytest.mark.parametrize("name", ["cylinder3d cli", "proj_schur=step"])
def test_run_fires_the_callback_once_a_chunk(runs, name):
    """The callback fires after each chunk with the chunk's diagnostics:
    the same chunk lengths and values as the reference's run."""
    _, jd, jchunks, ts, _, td, tchunks = runs[name]
    chunk = ts.config.numerics.steps_per_chunk
    lengths = [len(c.iters) for c in tchunks]
    assert lengths == [len(c.iters) for c in jchunks]
    assert sum(lengths) == STEPS and all(n == chunk for n in lengths[:-1])
    for tc, jc in zip(tchunks, jchunks):
        np.testing.assert_array_equal(tc.iters, np.asarray(jc.iters))
        np.testing.assert_allclose(tc.c_d, np.asarray(jc.c_d), rtol=1e-8)
    np.testing.assert_array_equal(np.concatenate([c.iters for c in tchunks]), td.iters)


def test_run_of_no_steps_returns_empty_diagnostics(runs):
    ts, tst = runs["cylinder3d cli"][3], runs["cylinder3d cli"][4]
    st, d = ts.run(0, state=tst)
    assert st is tst
    assert all(getattr(d, f.name).shape == (0,) for f in dataclasses.fields(d))


def test_run_warns_when_a_whole_chunk_hits_maxiter():
    cfg = cli_config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, maxiter=2))
    ts = NavierStokesSolver(cylinder_duct_3d(**DUCT), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    with pytest.warns(UserWarning, match="maxiter=2 for an entire chunk at step 2"):
        ts.run(2)


# ---------------------------------------------------------------------------
# the cylinder3d CLI
# ---------------------------------------------------------------------------
CLI_FLAGS = ["--lc", "0.25", "--nz", "3", "--n-steps", "4", "--steps-per-chunk", "2",
             "--dtype", "float64", "--output-every", "2", "--checkpoint-every", "2"]
CSV_FILES = ("gmres.csv", "coeff_2.csv", "forces_results_3D_2case.csv")


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Output dirs of the JAX CLI and the port's CLI on CLI_FLAGS, and of
    each resuming from the other's final.npz to 6 steps."""
    root = tmp_path_factory.mktemp("cli")
    d = {k: root / k for k in ("jax", "port", "jax_resumed", "port_resumed")}
    jcli.main(["cylinder3d", *CLI_FLAGS, "--output-dir", str(d["jax"])])
    tcli.main(["cylinder3d", *CLI_FLAGS, "--device", "cpu", "--output-dir", str(d["port"])])
    more = ["--n-steps", "6", "--steps-per-chunk", "2", "--dtype", "float64", "--lc", "0.25", "--nz", "3"]
    jcli.main(["cylinder3d", *more, "--resume", str(d["port"] / "final.npz"),
               "--output-dir", str(d["jax_resumed"])])
    tcli.main(["cylinder3d", *more, "--device", "cpu", "--resume", str(d["jax"] / "final.npz"),
               "--output-dir", str(d["port_resumed"])])
    return d


@pytest.mark.parametrize("pair", [("port", "jax"), ("port_resumed", "jax_resumed")])
def test_cli_writes_the_reference_files(cli_runs, pair):
    """The same files, headers and row counts; values to rtol 1e-7 (the
    wall-time columns of the forces file aside)."""
    out, ref = (cli_runs[k] for k in pair)
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in out.iterdir()) == names
    assert set(CSV_FILES) <= set(names) and "final.npz" in names
    for name in CSV_FILES:
        o, r = _rows(out / name), _rows(ref / name)
        assert len(o) == len(r) and len(r) >= 2
        if name.startswith("forces"):
            assert o[0] == r[0]
            o, r = [row[:5] for row in o[1:]], [row[:5] for row in r[1:]]
        np.testing.assert_allclose(np.asarray(o, float), np.asarray(r, float), rtol=1e-7, atol=1e-12)
    if pair[0] == "port":
        assert (out / "solution.pvd").read_text() == (ref / "solution.pvd").read_text().replace(
            str(ref), str(out))


def test_cli_checkpoints_load_into_both_packages(cli_runs):
    """Each package's final.npz loads into the other with the same keys and
    arrays, and each resumed run continued from step 4 to step 6."""
    for a, b in (("port", "jax"), ("port_resumed", "jax_resumed")):
        with np.load(cli_runs[a] / "final.npz") as za, np.load(cli_runs[b] / "final.npz") as zb:
            assert sorted(za.files) == sorted(zb.files)
    t_from_j = tckpt.load_checkpoint(str(cli_runs["jax"] / "final.npz"), dtype=torch.float64, device="cpu")
    j_from_t = jckpt.load_checkpoint(str(cli_runs["port"] / "final.npz"), dtype=jnp.float64)
    assert t_from_j.step == 4 and int(j_from_t.step) == 4
    for k in ("u", "p", "u_prev", "p_prev"):
        np.testing.assert_allclose(getattr(t_from_j, k).numpy(), np.asarray(getattr(j_from_t, k)),
                                   rtol=1e-8, atol=1e-10)
    t6 = tckpt.load_checkpoint(str(cli_runs["port_resumed"] / "final.npz"), dtype=torch.float64,
                             device="cpu")
    j6 = jckpt.load_checkpoint(str(cli_runs["jax_resumed"] / "final.npz"), dtype=jnp.float64)
    assert t6.step == 6 and int(j6.step) == 6
    np.testing.assert_allclose(t6.u.numpy(), np.asarray(j6.u), rtol=1e-8, atol=1e-10 * np.abs(j6.u).max())
    assert len(_rows(cli_runs["port_resumed"] / "gmres.csv")) == 2
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tckpt.load_checkpoint(str(cli_runs["jax"] / "final.npz"))


def test_cli_refuses_what_is_not_ported(tmp_path):
    """--debug-nans (a JAX debugging mode) and an unknown kind are refused;
    --shard-cells 2, once refused, runs on two local ranks and writes the
    CLI's files (its match with the JAX CLI is in tests/test_torch_sharding.py)."""
    with pytest.raises(SystemExit, match="--debug-nans"):
        tcli.main(["cylinder3d", "--debug-nans", "--device", "cpu", "--output-dir", str(tmp_path)])
    tcli.main(["cylinder3d", "--shard-cells", "2", "--lc", "0.25", "--nz", "3", "--n-steps", "1",
               "--device", "cpu", "--output-dir", str(tmp_path / "sharded")])
    assert all((tmp_path / "sharded" / f).exists() for f in (*CSV_FILES, "final.npz"))
    with pytest.raises(SystemExit, match="precond.kind"):
        tcli.main(["cylinder3d", "--precond", "lsc", "--device", "cpu", "--n-steps", "1",
                   "--lc", "0.25", "--nz", "3", "--output-dir", str(tmp_path)])


def test_cli_runs_without_jax(tmp_path):
    """The port's cylinder3d CLI at its float32 default in a fresh
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

        main(["cylinder3d", "--lc", "0.25", "--nz", "3", "--n-steps", "2",
              "--steps-per-chunk", "1", "--device", "cpu", "--output-dir", sys.argv[2]])
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
    assert "Total wall time" in res.stdout
    assert len(_rows(tmp_path / "gmres.csv")) == 2 and (tmp_path / "final.npz").exists()
