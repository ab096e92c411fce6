"""BDF2 in the PyTorch port against the JAX package.

Trajectories: 3 steps at float64 under `time.scheme="bdf2"` (BDF1 on the
first step, then the three-level history with extrapolated convection at
dt_eff = dt / 1.5), run by both packages:

  * monolithic: the cylinder2d CLI's defaults on the 2D channel;
  * projection on the macro path: the benchmark's settings
    (chip_smoke.bench_config) on the small duct;
  * projection element fallback: the same with the element F, rhs, D and G;
  * explicit convection: the Adams-Bashforth-2 rhs 2 N(u^n) - N(u^{n-1})
    carried in `State.conv_prev`.

With equal per-step iteration counts the two differ by summation order
only: u to rtol 1e-8, p to 1e-7, c_d and the pressure difference to 1e-8
(tests/test_torch_monolithic.py's standard).  Then the reference's
temporal-order test (tests/test_bdf2.py), run in the port: BDF2 is second
order in dt, BDF1 first, on the Ethier-Steinman cube.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu.io import checkpoint as jckpt
from navierstokes_project_nm4pde_tpu.mesh import cylinder_channel_2d as jax_channel
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder2DProblem as JaxCylinder2D
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu_torch import config as tconfig
from navierstokes_project_nm4pde_tpu_torch.io import checkpoint as tckpt
from navierstokes_project_nm4pde_tpu_torch.mesh import cube_mesh, cylinder_channel_2d, cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder2DProblem,
    Cylinder3DProblem,
    EthierSteinmanProblem,
    NavierStokesSolver,
)
from test_torch_2d import assert_same_run, cylinder2d_config
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
DUCT = dict(lc=0.22, nz=3)
BDF2 = {"time": dict(scheme="bdf2"), "numerics": dict(steps_per_chunk=1)}
ELEMENT = dict(f_apply="element", macro_rhs="off", macro_wfuse="off", grad_apply="element",
               div_apply="element")


def bench_bdf2(time=None, numerics=None):
    return chip_smoke.with_changes(chip_smoke.bench_config("float64"), {
        "time": {**BDF2["time"], **(time or {})},
        "numerics": {**BDF2["numerics"], **(numerics or {})},
    })


# name -> (geometry, config)
CASES = {
    "monolithic (cylinder2d defaults)": ("channel", cylinder2d_config("--scheme", "bdf2")),
    "projection, macro": ("duct", bench_bdf2()),
    "projection, element fallback": ("duct", bench_bdf2(numerics=ELEMENT)),
    "explicit (AB2)": ("duct", bench_bdf2(time=dict(convection="explicit"))),
}


def _geometries(name):
    if name == "channel":
        return ((jax_channel(lc=0.12), JaxCylinder2D(test_case=2)),
                (cylinder_channel_2d(lc=0.12), Cylinder2DProblem(test_case=2)))
    return ((jax_duct(**DUCT), JaxCylinder3D(test_case=2)),
            (cylinder_duct_3d(**DUCT), Cylinder3DProblem(test_case=2)))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (geom, cfg) in CASES.items():
        (jm, jp), (tm, tp) = _geometries(geom)
        js = JaxSolver(jm, jp, jax_config(cfg))
        jst, jd = js.run(STEPS)
        ts = NavierStokesSolver(tm, tp, cfg, device="cpu")
        tst, td = ts.run(STEPS)
        out[name] = (js, jst, jd, ts, tst, td)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_bdf2_matches_reference(runs, name):
    js, jst, jd, ts, tst, td = runs[name]
    assert ts.config.time.scheme == "bdf2"
    assert_same_run(jst, jd, tst, td)
    # the history BDF2 carries
    np.testing.assert_allclose(tst.u_prev.numpy(), np.asarray(jst.u_prev), rtol=1e-8,
                               atol=1e-10 * np.abs(np.asarray(jst.u_prev)).max())


def test_bdf2_paths(runs):
    """BDF2 keeps the projection stepper off the constant-K operator (its
    velocity block changes after step 0): explicit convection applies K
    through the element passes, and the macro path stays the default."""
    assert runs["projection, macro"][3].f_apply == "macro"
    ex = runs["explicit (AB2)"][3]
    assert ex.kcsr is None and ex.f_apply == "element"
    assert runs["projection, element fallback"][3].f_apply == "element"


def test_explicit_bdf2_carries_the_previous_convection(runs):
    """conv_prev = N(u^n) of the last step, as the reference's; a BDF1 or
    implicit state carries none."""
    _, jst, _, _, tst, _ = runs["explicit (AB2)"]
    ref = np.asarray(jst.conv_prev)
    assert tst.conv_prev is not None and np.abs(ref).max() > 0
    np.testing.assert_allclose(tst.conv_prev.numpy(), ref, rtol=1e-8, atol=1e-10 * np.abs(ref).max())
    assert runs["projection, macro"][4].conv_prev is None
    ts = runs["explicit (AB2)"][3]
    st0 = ts.initial_state()
    assert st0.conv_prev is not None and float(st0.conv_prev.abs().max()) == 0.0


def test_conv_prev_checkpoints_load_into_both_packages(runs, tmp_path):
    """An explicit BDF2 state's checkpoint (conv_prev under the reference's
    key) loads into the other package, and a run resumed from it takes the
    reference's next step."""
    js, jst, _, ts, tst, _ = runs["explicit (AB2)"]
    tckpt.save_checkpoint(str(tmp_path / "port.npz"), tst)
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), jst)
    with np.load(tmp_path / "port.npz") as zp, np.load(tmp_path / "jax.npz") as zj:
        assert "conv_prev" in zp.files and sorted(zp.files) == sorted(zj.files)
    j_from_t = jckpt.load_checkpoint(str(tmp_path / "port.npz"), dtype=jnp.float64)
    t_from_j = tckpt.load_checkpoint(str(tmp_path / "jax.npz"), dtype=torch.float64, device="cpu")
    for k in ("u", "p", "u_prev", "conv_prev"):
        ref = np.asarray(getattr(jst, k))
        np.testing.assert_allclose(np.asarray(getattr(j_from_t, k)), ref, rtol=1e-8, atol=1e-10 * np.abs(ref).max())
        np.testing.assert_allclose(getattr(t_from_j, k).numpy(), ref, rtol=0, atol=0)
    jst4, jd4 = js.run(1, state=j_from_t)
    tst4, td4 = ts.run(1, state=t_from_j)
    np.testing.assert_array_equal(td4.iters, np.asarray(jd4.iters))
    ref = np.asarray(jst4.u)
    np.testing.assert_allclose(tst4.u.numpy(), ref, rtol=1e-8, atol=1e-10 * np.abs(ref).max())


def test_bdf2_smoother_bound_at_the_warm_steps_dt():
    """The damped smoothers' set-up spectral bound is taken at dt / 1.5, the
    dt_eff of BDF2's warm steps, as the reference's."""
    cfg = cylinder2d_config("--scheme", "bdf2", "--f-solver", "chebyshev")
    js = JaxSolver(jax_channel(lc=0.12), JaxCylinder2D(test_case=2), jax_config(cfg))
    ts = NavierStokesSolver(cylinder_channel_2d(lc=0.12), Cylinder2DProblem(test_case=2), cfg, device="cpu")
    np.testing.assert_allclose(float(ts._f_lam0), float(js._f_lam0), rtol=1e-10)
    bdf1 = dataclasses.replace(cfg, time=dataclasses.replace(cfg.time, scheme="bdf1"))
    t1 = NavierStokesSolver(cylinder_channel_2d(lc=0.12), Cylinder2DProblem(test_case=2), bdf1, device="cpu")
    assert float(t1._f_lam0) != float(ts._f_lam0)


T_END = 0.2


def _run_scheme(mesh, scheme, dt):
    cfg = tconfig.RunConfig(
        time=tconfig.TimeConfig(dt=dt, t_end=T_END, scheme=scheme),
        solver=tconfig.SolverConfig(rtol=1e-10, restart=60, maxiter=300),
        precond=tconfig.PrecondConfig(kind="asimple", f_iters=6, s_iters=35),
        numerics=tconfig.NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=8),
    )
    state, _ = NavierStokesSolver(mesh, EthierSteinmanProblem(), cfg, device="cpu").run(round(T_END / dt))
    assert abs(state.t - T_END) < 1e-12
    return state.u.numpy()


def test_bdf2_second_order_in_time():
    """Errors against a dt = T/64 BDF2 run on the same mesh (the
    time-discretisation error alone): BDF2 second order, BDF1 first."""
    mesh = cube_mesh(2)
    ref = _run_scheme(mesh, "bdf2", T_END / 64)
    errs = {
        scheme: [np.sqrt(np.mean((_run_scheme(mesh, scheme, T_END / n) - ref) ** 2)) for n in (4, 8)]
        for scheme in ("bdf1", "bdf2")
    }
    rate1 = np.log2(errs["bdf1"][0] / errs["bdf1"][1])
    rate2 = np.log2(errs["bdf2"][0] / errs["bdf2"][1])
    assert 0.7 < rate1 < 1.5, (errs, rate1)
    assert rate2 > 1.7, (errs, rate2)
    assert errs["bdf2"][1] < errs["bdf1"][1]
