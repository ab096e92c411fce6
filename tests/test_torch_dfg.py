"""The port's DFG validation modules against the reference's scripts, on the
CPU.

`navierstokes_project_nm4pde_tpu_torch.validation.dfg_validate` (DFG 2D-2)
and `.dfg3d_validate` (DFG 3D-1Z) against `scripts/dfg_validate.py` and
`scripts/dfg3d_validate.py`:

- the inlets (`kicked_inlet`, `ramped`) on random points at times before,
  at and after the ramp's and the kick's ends, to 1e-14 (the same float64
  arithmetic, the kick's switch decided on the host in the port);
- the estimators (`strouhal_from_lift`, `smooth`) on the signals of
  tests/test_dfg_tools.py: equal (the same numpy code);
- 12-step trajectories at float64: the run each module's `build` makes
  against the JAX solver built as each script builds it (the 2D channel at
  lc 0.12, the duct at (0.25, 3), dt 2e-3, the ramp ending at step 5 and
  the 2D kick at step 8): equal F and S counts each step, c_d, c_l and
  delta-p within rtol 1e-8 (the standard of tests/test_torch_slice.py);
- both `main`s on a tiny float32 run (20 steps at lc 0.12; the 3D one on
  the (0.25, 3) duct), the port's in a fresh interpreter in which neither
  jax nor the JAX package can be imported: the same summary keys and CSV
  header, values within 1e-4 relative, with these exceptions, each the
  float32 rounding of both packages carried through an ill-conditioned
  step (the port's float64 run of the same 20 steps shows it):
  `steps_per_sec` is a wall-clock rate and is not compared; a lift value
  is held to 1e-4 of the drag (lift is a small difference of force
  integrals on drag's scale, as chip_smoke holds it); the Strouhal number
  of a 20-step window without shedding is the parabolic peak fit of the
  lift's trend, to 5e-3 relative (each package's float32 run lies 1.3e-3
  and 1.5e-3 from the float64 run's, 2.1e-3 from each other); the 3D
  drift, (c_d at the window's end - c_d at its start) / mean c_d, to 2e-4
  absolute (twice c_d's 1e-4); iterations a step within one (a float32
  solve may cross rtol one iteration later: 9 against 10 at one step of
  the 3D run).  The CSV files' c_d, c_l and delta-p are held to 1e-4 of
  their scale up to the first step whose iteration counts differ (the 3D
  run's 17th; after it c_d moves by up to 1.2e-4 of its value);
- the JAX package's own float32 spread on chip_smoke's small DFG checks
  (DFG_SMALL), held under half of each card tolerance, as
  tests/test_torch_slice_f32.py holds SMALL_CHECKS'.
"""

import csv
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu import config as jconfig
from navierstokes_project_nm4pde_tpu.mesh import cylinder_channel_2d as jax_channel
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder2DProblem as JaxCylinder2D
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder2DProblem, Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.validation import dfg3d_validate, dfg_validate
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import dfg3d_validate as script3d  # noqa: E402
import dfg_validate as script2d  # noqa: E402

STEPS = 12
DT = 2e-3
FLAGS_2D = ["--lc", "0.12", "--dt", str(DT), "--t-ramp", "0.01", "--t-kick", "0.016",
            "--t-end", str(STEPS * DT), "--chunk", "4"]
FLAGS_3D = ["--lc", "0.25", "--nz", "3", "--dt", str(DT), "--t-ramp", "0.01",
            "--t-end", str(STEPS * DT), "--chunk", "4"]
MAIN_2D = ["--lc", "0.12", "--t-end", "0.04", "--dt", "2e-3", "--chunk", "5", "--t-measure", "0"]
MAIN_3D = ["--lc", "0.25", "--nz", "3", "--t-end", "0.04", "--dt", "2e-3", "--chunk", "5"]
MAIN_RTOL = 1e-4
LIFT_KEYS = ("cl_max", "cl_min", "cl_max_raw", "cl")
ST_RTOL = 5e-3
DRIFT_ATOL = 2e-4


def _points(rng, n=64):
    return rng.uniform([0.0, 0.0], [2.2, 0.41], size=(n, 2))


# t_ramp 1 and t_kick 2 (the 2D script's defaults): before, at and after each end
TIMES = (0.25, 0.999, 1.0, 1.5, 1.999, 2.0, 2.7)


@pytest.mark.parametrize("t", TIMES)
def test_kicked_inlet_matches_script(t):
    u_mean = 1.0
    x = _points(np.random.default_rng(3))
    ref = script2d.kicked_inlet(JaxCylinder2D(test_case=4, u_m=1.5 * u_mean).dirichlet[0], u_mean, 2.0, 3.0,
                                t_ramp=1.0)(jnp.asarray(x), t)
    out = dfg_validate.kicked_inlet(Cylinder2DProblem(test_case=4, u_m=1.5 * u_mean).dirichlet[0], u_mean, 2.0,
                                    3.0, t_ramp=1.0)(torch.as_tensor(x), t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-15)
    if t < 2.0:  # the kick is on: a transverse component
        assert np.abs(out.numpy()[:, 1]).max() > 0


@pytest.mark.parametrize("t", (0.1, 0.5, 0.7))
def test_ramped_matches_script(t):
    x = np.random.default_rng(4).uniform([0.0, 0.0, 0.0], [2.5, 0.41, 0.41], size=(64, 3))
    ref = script3d.ramped(JaxCylinder3D(test_case=2, u_m=0.45).dirichlet[0], 0.5)(jnp.asarray(x), t)
    out = dfg3d_validate.ramped(Cylinder3DProblem(test_case=2, u_m=0.45).dirichlet[0], 0.5)(torch.as_tensor(x), t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-15)


def _signals():
    """tests/test_dfg_tools.py's signals: name -> (t, c_l)."""
    t6 = np.arange(1, 6001) * 1e-3
    rng = np.random.default_rng(7)
    return {
        "clean": (t6, 0.2 + np.sin(2 * np.pi * 3.0 * t6 + 0.3)),
        "jitter": (t6, np.sin(2 * np.pi * 3.0 * t6) + 0.4 * rng.standard_normal(len(t6))),
        "smooth": (np.arange(1, 4001) * 1e-3, np.sin(2 * np.pi * 3.0 * np.arange(1, 4001) * 1e-3)),
        "short": (np.arange(1, 9) * 1e-3, np.sin(np.arange(1, 9) * 1e-3)),
    }


@pytest.mark.parametrize("name", ["clean", "jitter", "smooth", "short"])
def test_estimators_match_script(name):
    t, cl = _signals()[name]
    if name == "smooth":
        np.testing.assert_array_equal(dfg_validate.smooth(cl, 10), script2d.smooth(cl, 10))
    else:
        out, ref = dfg_validate.strouhal_from_lift(t, cl, 1.0, 0.1), script2d.strouhal_from_lift(t, cl, 1.0, 0.1)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def _jax_config(args, dtype):
    """The RunConfig each script builds (scripts/dfg_validate.py:163-172,
    dfg3d_validate.py:88-97), at `dtype`."""
    return jconfig.RunConfig(
        time=jconfig.TimeConfig(dt=args.dt, t_end=args.t_end, scheme=args.scheme,
                                stepper=getattr(args, "stepper", "projection")),
        solver=jconfig.SolverConfig(rtol=1e-6, maxiter=args.maxiter, tol_mode="b"),
        precond=jconfig.PrecondConfig(kind="yosida", f_iters=0, s_iters=3, s_solver="mg2_cg"),
        numerics=jconfig.NumericsConfig(dtype=dtype, precise_dots=False, steps_per_chunk=args.chunk),
    )


def _jax_run_2d(args, dtype="float64"):
    """The 2D script's run (scripts/dfg_validate.py:130-172) at `dtype`."""
    u_mean = args.re * 1e-3 / 0.1
    problem = JaxCylinder2D(test_case=4, nu=1e-3, u_m=1.5 * u_mean)
    dirichlet = dict(problem.dirichlet)
    dirichlet[0] = script2d.kicked_inlet(dirichlet[0], u_mean, args.t_kick, 0.3 * u_mean / 0.1, t_ramp=args.t_ramp)
    problem = dataclasses.replace(problem, dirichlet=dirichlet, probe_points=((0.15, 0.2), (0.25, 0.2)))
    return JaxSolver(jax_channel(lc=args.lc), problem, _jax_config(args, dtype))


def _jax_run_3d(args, dtype="float64"):
    """The 3D script's run (scripts/dfg3d_validate.py:80-97) at `dtype`."""
    problem = JaxCylinder3D(test_case=2, u_m=args.u_m)
    dirichlet = dict(problem.dirichlet)
    dirichlet[0] = script3d.ramped(dirichlet[0], args.t_ramp)
    problem = dataclasses.replace(problem, dirichlet=dirichlet)
    return JaxSolver(jax_duct(lc=args.lc, nz=args.nz), problem, _jax_config(args, dtype))


@pytest.fixture(scope="module", params=["2D-2", "3D-1Z"])
def trajectory(request):
    """Both packages' 12 steps at float64: (port diagnostics, JAX
    diagnostics, the port's configuration and steps)."""
    mod, flags, jax_run = {
        "2D-2": (dfg_validate, FLAGS_2D, _jax_run_2d), "3D-1Z": (dfg3d_validate, FLAGS_3D, _jax_run_3d),
    }[request.param]
    args = mod.parser().parse_args(flags)
    mesh, problem, cfg, n = mod.build(args)
    cfg = dataclasses.replace(cfg, numerics=dataclasses.replace(cfg.numerics, dtype="float64"))
    _, td = NavierStokesSolver(mesh, problem, cfg, device="cpu").run(n)
    _, jd = jax_run(args).run(n)
    return dict(td=td, jd=jd, cfg=cfg, n=n, name=request.param)


def test_trajectory_builds_the_scripts_run(trajectory):
    cfg = trajectory["cfg"]
    assert trajectory["n"] == STEPS
    assert (cfg.time.stepper, cfg.time.scheme, cfg.precond.kind, cfg.precond.s_solver) == (
        "projection", "bdf2", "yosida", "mg2_cg")
    assert (cfg.solver.rtol, cfg.solver.tol_mode, cfg.numerics.precise_dots) == (1e-6, "b", False)


def test_trajectory_matches_reference_iteration_counts(trajectory):
    td, jd = trajectory["td"], trajectory["jd"]
    np.testing.assert_array_equal(td.iters_f, np.asarray(jd.iters_f))
    np.testing.assert_array_equal(td.iters_s, np.asarray(jd.iters_s))


@pytest.mark.parametrize("key", ["c_d", "c_l", "delta_p"])
def test_trajectory_matches_reference_coefficients(trajectory, key):
    out, ref = getattr(trajectory["td"], key), np.asarray(getattr(trajectory["jd"], key))
    assert np.all(np.isfinite(out)) and np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8 * np.abs(ref).max())


@pytest.mark.parametrize("name", list(chip_smoke.DFG_SMALL))
def test_reference_float32_spread_is_within_half_the_card_tolerance(name):
    """The JAX package's own float32 run of chip_smoke's small DFG check
    (the scripts' run on the small channel / duct, AGREE_STEPS steps)
    against its float64 run, measured as `check_small` measures the card
    (u and p at the last step, the coefficients over the steps; c_l on
    c_d's scale): under half the card's tolerance (printed with -s)."""
    flags, tol = chip_smoke.DFG_SMALL[name]
    mod, jax_run = {"2D-2": (dfg_validate, _jax_run_2d), "3D-1Z": (dfg3d_validate, _jax_run_3d)}[name]
    args = mod.parser().parse_args(flags)
    runs = {}
    for dtype in ("float32", "float64"):
        st, d = jax_run(args, dtype).run(chip_smoke.AGREE_STEPS)
        runs[dtype] = {k: np.asarray(getattr(st, k), np.float64) for k in ("u", "p")}
        runs[dtype].update({k: np.asarray(getattr(d, k), np.float64) for k in ("c_d", "c_l", "delta_p")})
    errs = chip_smoke.small_errors(runs["float32"], runs["float64"])
    print(f"DFG {name} small, the JAX package's float32 spread: {errs}")
    assert max(errs.values()) <= tol / 2, (errs, tol)


_PORT_MAINS = textwrap.dedent(
    """
    import json, sys

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
    from navierstokes_project_nm4pde_tpu_torch.validation import dfg3d_validate, dfg_validate

    dfg_validate.main(json.loads(sys.argv[2]) + ["--device", "cpu", "--out-dir", sys.argv[4]])
    dfg3d_validate.main(json.loads(sys.argv[3]) + ["--device", "cpu", "--out-dir", sys.argv[4]])
    assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
    """
)


def _run(cmd, **kw):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}, **kw)
    assert res.returncode == 0, res.stdout + res.stderr
    return res


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """Each package's two summaries and CSV files of the tiny float32 runs."""
    out = {}
    port_dir = tmp_path_factory.mktemp("port")
    res = _run([sys.executable, "-c", _PORT_MAINS, str(REPO), json.dumps(MAIN_2D), json.dumps(MAIN_3D),
                str(port_dir)])
    lines = res.stdout.strip().splitlines()
    out["port"] = dict(zip(("2D-2", "3D-1Z"), map(json.loads, lines[-2:])), dir=port_dir, stderr=res.stderr)
    jax_dir = tmp_path_factory.mktemp("jax")
    out["jax"] = dict(dir=jax_dir)
    for name, script, flags in (("2D-2", "dfg_validate.py", MAIN_2D), ("3D-1Z", "dfg3d_validate.py", MAIN_3D)):
        res = _run([sys.executable, str(REPO / "scripts" / script), *flags, "--out-dir", str(jax_dir)])
        out["jax"][name] = json.loads(res.stdout.strip().splitlines()[-1])
    return out


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_mains_run_without_jax_and_name_the_device(mains):
    err = mains["port"]["stderr"]
    assert "# Re=100 mesh 226 cells" in err and "# 3D-1Z Re=20 mesh" in err and "device cpu" in err


@pytest.mark.parametrize("name,csv_name", [("2D-2", "coeff_re100.csv"), ("3D-1Z", "coeff_3d1z.csv")])
def test_mains_match_scripts(mains, name, csv_name):
    out, ref = mains["port"][name], mains["jax"][name]
    assert list(out) == list(ref)
    drag = abs(ref["cd_max" if "cd_max" in ref else "cd"])
    for k, r in ref.items():
        o = out[k]
        if k == "steps_per_sec":
            assert o > 0
        elif isinstance(r, (str, dict, list)) or k in ("dofs", "cells", "n_periods"):
            assert o == r, k
        elif k in LIFT_KEYS:
            assert abs(o - r) <= MAIN_RTOL * drag, (k, o, r)
        elif k == "strouhal":
            assert abs(o - r) <= ST_RTOL * abs(r), (k, o, r)
        elif k == "cd_drift_rel":
            assert abs(o - r) <= DRIFT_ATOL, (k, o, r)
        elif k == "iters_per_step_warm":
            assert abs(o - r) <= 1, (k, o, r)
        else:
            assert abs(o - r) <= MAIN_RTOL * abs(r), (k, o, r)
    rows, jrows = _rows(mains["port"]["dir"] / csv_name), _rows(mains["jax"]["dir"] / csv_name)
    assert rows[0] == jrows[0] == ["t", "c_d", "c_l", "delta_p", "iters"]
    a, b = np.array(rows[1:], float), np.array(jrows[1:], float)
    assert a.shape == b.shape == (20, 5)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    assert np.abs(a[:, 4] - b[:, 4]).max() <= 1
    # the steps before the first whose iteration counts differ
    k = int(np.argmax(a[:, 4] != b[:, 4])) if np.any(a[:, 4] != b[:, 4]) else len(a)
    assert k >= 10
    for col, scale in ((1, 1), (2, 1), (3, 3)):  # c_d, c_l (on drag's scale), delta_p
        assert np.abs(a[:k, col] - b[:k, col]).max() <= MAIN_RTOL * np.abs(b[:, scale]).max(), col
