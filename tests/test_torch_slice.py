"""The PyTorch port's projection stepper against the JAX solver, end to end.

Both solvers run the benchmark's solver settings (projection stepper,
implicit convection, macro F, frozen banded Schur with the additive
two-level preconditioner, restart 8, maxiter 60, tol_mode "b", quadratic
velocity warm start, s_recycle 1, freeze_conv_diag) at float64 on a small
DFG duct.  With equal per-step F and S iteration counts the two differ by
summation order only, so u and p are held to rtol 1e-8 / 1e-7 (the
reference's own macro-vs-element step tolerances, tests/test_macro.py) and
the drag/lift coefficients and pressure difference to rtol 1e-8.  Each
package builds the mesh and the configuration with its own modules
(tests/test_torch_port_copies.py holds the copies equal).
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu_torch.device import pick_device
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
    state_from_numpy,
    state_to_numpy,
)
from navierstokes_project_nm4pde_tpu_torch.ops import macroblock, onehot, scatter
from test_torch_port_copies import jax_config

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "navierstokes_project_nm4pde_tpu_torch"


def bench_config(dtype="float64"):
    """The configuration chip_smoke.py drives (bench.py's defaults), at a
    test dtype and with the reference stepping one step per chunk."""
    cfg = chip_smoke.bench_config(dtype)
    return dataclasses.replace(
        cfg, numerics=dataclasses.replace(cfg.numerics, steps_per_chunk=1)
    )


def _jax_state_numpy(st):
    return {
        k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
        for k in ("u", "p", "t", "step", "u_prev", "p_prev", "u_prev2", "spool")
    }


@pytest.fixture(scope="module")
def runs():
    """JAX: 2 steps, then 1 more; the port: 3 steps from the start."""
    cfg = bench_config()
    js = JaxSolver(jax_duct(lc=0.22, nz=3), JaxCylinder3D(test_case=2), jax_config(cfg))
    st2, d2 = js.run(2)
    st3, d3 = js.run(1, state=st2)
    ts = NavierStokesSolver(
        cylinder_duct_3d(lc=0.22, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu"
    )
    tst, td = ts.run(3)
    return dict(js=js, st2=st2, st3=st3, d2=d2, d3=d3, ts=ts, tst=tst, td=td)


def _cat(r, key):
    return np.concatenate([getattr(r["d2"], key), getattr(r["d3"], key)])


def test_port_mesh_and_plan_match_reference(runs):
    js, ts = runs["js"], runs["ts"]
    np.testing.assert_array_equal(ts.space.cells_u, js.space.cells_u)
    np.testing.assert_array_equal(ts.macro.uidx.numpy(), np.asarray(js._macro.uidx))
    assert ts.space.n_dofs == js.space.n_dofs


def test_three_steps_match_reference_iteration_counts(runs):
    np.testing.assert_array_equal(runs["td"].iters_f, _cat(runs, "iters_f"))
    np.testing.assert_array_equal(runs["td"].iters_s, _cat(runs, "iters_s"))
    assert np.all(runs["td"].iters_f < 60) and np.all(runs["td"].iters_s < 60)


def test_three_steps_match_reference_state(runs):
    st3, tst = runs["st3"], runs["tst"]
    ju, jp = np.asarray(st3.u), np.asarray(st3.p)
    np.testing.assert_allclose(tst.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(tst.p.numpy(), jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())
    assert tst.step == int(st3.step) == 3


@pytest.mark.parametrize("key", ["c_d", "c_l", "delta_p"])
def test_three_steps_match_reference_functionals(runs, key):
    ref = _cat(runs, key)
    np.testing.assert_allclose(getattr(runs["td"], key), ref, rtol=1e-8, atol=0.0)


def test_state_carry_over_continues_the_reference_run(runs):
    ts = runs["ts"]
    s2 = state_from_numpy(_jax_state_numpy(runs["st2"]), "cpu")
    st3, d3 = ts.run(1, state=s2)
    np.testing.assert_array_equal(d3.iters_f, runs["d3"].iters_f)
    np.testing.assert_array_equal(d3.iters_s, runs["d3"].iters_s)
    ju = np.asarray(runs["st3"].u)
    np.testing.assert_allclose(st3.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(d3.c_d, runs["d3"].c_d, rtol=1e-8)
    # and back: numpy arrays of the port's state load into the same state
    back = state_from_numpy(state_to_numpy(st3), "cpu")
    for k in ("u", "p", "u_prev", "p_prev", "u_prev2", "spool"):
        assert torch.equal(getattr(back, k), getattr(st3, k))
    assert (back.t, back.step) == (st3.t, st3.step)


def test_solver_rejects_configs_outside_the_slice():
    """Each value the port does not run yet raises, naming the field."""
    mesh = cylinder_duct_3d(lc=0.25, nz=3)
    cfg = bench_config()

    def rep(part, **kw):
        return dataclasses.replace(cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})

    mono = rep("time", stepper="monolithic")
    bdf2_explicit = rep("time", scheme="bdf2", convection="explicit")
    bad = [
        # bdf2 runs; the constant-K operator stays BDF1's
        (dataclasses.replace(bdf2_explicit, numerics=dataclasses.replace(
            bdf2_explicit.numerics, vel_apply="bsr")), "scheme 'bdf1'"),
        (rep("time", convection="imex", imex_umax=None), "imex_umax"),
        (rep("numerics", vel_apply="bsr"), "vel_apply"),
        (dataclasses.replace(mono, time=dataclasses.replace(mono.time, convection="explicit")),
         "convection='explicit' requires the projection stepper"),
        (dataclasses.replace(mono, numerics=dataclasses.replace(mono.numerics, f_apply="macro")),
         "f_apply='macro'"),
    ]
    for c, name in bad:
        with pytest.raises(ValueError, match=name):
            NavierStokesSolver(mesh, Cylinder3DProblem(), c, device="cpu")
    # dim 2 runs on a 2D mesh; a problem of another dimension than its mesh
    # is refused
    with pytest.raises(ValueError, match="problem.dim"):
        NavierStokesSolver(
            mesh, dataclasses.replace(Cylinder3DProblem(), dim=2), cfg, device="cpu"
        )


def test_plain_cg_single_run_matches_reference_iteration_counts():
    """precond.s_recycle=0: the pressure Poisson runs plain CG on both sides
    (the port's batched `cg` with one column)."""
    cfg = bench_config()
    cfg = dataclasses.replace(cfg, precond=dataclasses.replace(cfg.precond, s_recycle=0))
    _, jd = JaxSolver(jax_duct(lc=0.22, nz=3), JaxCylinder3D(test_case=2), jax_config(cfg)).run(3)
    ts = NavierStokesSolver(
        cylinder_duct_3d(lc=0.22, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu"
    )
    st, td = ts.run(3)
    assert st.spool is None
    np.testing.assert_array_equal(td.iters_f, np.asarray(jd.iters_f))
    np.testing.assert_array_equal(td.iters_s, np.asarray(jd.iters_s))
    np.testing.assert_allclose(td.c_d, np.asarray(jd.c_d), rtol=1e-8)


def _imported_modules(path):
    """Every module that an import statement of the file `path` names."""
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


_FORBIDDEN = ("jax", "jaxlib", "navierstokes_project_nm4pde_tpu")


def test_port_imports_no_jax_module():
    """No module of the port imports jax, jaxlib, or the JAX package or any
    module of it (not even one that is numpy only): the port keeps its own
    copies.  No file of the port names the JAX package as a module."""
    files = sorted(PKG.rglob("*.py"))
    assert files
    for path in files:
        text = path.read_text()
        assert "import jax" not in text, path
        assert "navierstokes_project_nm4pde_tpu." not in text, path
        assert "navierstokes_project_nm4pde_tpu " not in text, path
        for name in _imported_modules(path):
            assert name.split(".")[0] not in _FORBIDDEN, (path, name)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports the port (its `config`, `mesh`, models and
    kernels) and nothing of jax or of the JAX package."""
    names = list(_imported_modules(REPO / "chip_smoke.py"))
    assert "navierstokes_project_nm4pde_tpu_torch.config" in names
    assert "navierstokes_project_nm4pde_tpu_torch.mesh" in names
    for name in names:
        assert name.split(".")[0] not in _FORBIDDEN, name


def test_port_slice_runs_without_jax():
    """The port's 2-step slice in a fresh interpreter in which neither jax
    nor the JAX package can be imported at all."""
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
        import numpy as np
        from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
        from navierstokes_project_nm4pde_tpu_torch.models import (
            Cylinder3DProblem, NavierStokesSolver,
        )
        from chip_smoke import bench_config

        s = NavierStokesSolver(
            cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(),
            bench_config("float32"), device="cpu",
        )
        st, d = s.run(2)
        assert np.all(np.isfinite(d.c_d)), d
        assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
        print("OK", d.iters_f.tolist(), d.iters_s.tolist())
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK"), res.stdout


def test_entry_points_default_to_the_card():
    """With no device the port builds on the card, and without one it
    raises instead of running on the CPU; "cpu" is what the tests ask for."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pick_device(None)
    assert pick_device("cpu") == torch.device("cpu")
    mesh = cylinder_duct_3d(lc=0.25, nz=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NavierStokesSolver(mesh, Cylinder3DProblem(), bench_config())
    cells = np.arange(20).reshape(2, 10)
    for build in (
        lambda: macroblock.build_macro_plan(cells, 20, U=32, c_blk=2),
        lambda: onehot.build_onehot_plans(cells, 20),
        lambda: scatter.build_segment_plan(cells, 20),
        lambda: scatter.build_inverse_map([cells[0]], 20),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert macroblock.build_macro_plan(cells, 20, U=32, c_blk=2, device="cpu").lidx.device.type == "cpu"
