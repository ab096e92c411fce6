"""How far the JAX package's own float32 run lies from its float64 run, for
each 2D, BDF2 and Ethier-Steinman configuration `chip_smoke.py` checks on
the card (chip_smoke.SMALL_CHECKS).

On the card the port runs float32 and is held to its CPU float64 run.
This test measures the reference's spread with the same meshes, steps and
measure as chip_smoke's `check_small` (max error over the steps relative
to max |float64|; c_l relative to max |c_d|; the Ethier-Steinman run has
no forces) and holds it under half of each card tolerance, so that the
card is held to what the reference itself achieves with a factor 2 for
another summation order.  The spreads are printed (pytest -s).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from navierstokes_project_nm4pde_tpu import mesh as jmesh
from navierstokes_project_nm4pde_tpu import models as jmodels
from test_torch_port_copies import jax_config

REPO = Path(__file__).resolve().parent.parent


def jax_geometry(name):
    """The JAX package's (mesh, problem) of a SMALL_CHECKS geometry."""
    if name == "channel":
        return jmesh.cylinder_channel_2d(**chip_smoke.SMALL_CHANNEL), jmodels.Cylinder2DProblem(test_case=2)
    if name == "duct":
        return jmesh.cylinder_duct_3d(**chip_smoke.SMALL_DUCT), jmodels.Cylinder3DProblem(test_case=2)
    return jmesh.cube_mesh(chip_smoke.SMALL_CUBE), jmodels.EthierSteinmanProblem()


def _run(name, dtype, tmp_path):
    geom, spec, steps, _ = chip_smoke.SMALL_CHECKS[name]
    if geom == "cube" and dtype == "float32":
        return _run_without_x64(name, tmp_path)
    js = jmodels.NavierStokesSolver(*jax_geometry(geom), jax_config(chip_smoke.small_config(spec, dtype)))
    st, d = js.run(steps)
    out = {k: np.asarray(getattr(st, k), np.float64) for k in ("u", "p")}
    out.update({k: np.asarray(getattr(d, k), np.float64) for k in ("c_d", "c_l", "delta_p")})
    return out, np.asarray(d.iters)


def _run_without_x64(name, tmp_path):
    """The run in a process of its own with JAX's 64-bit mode off: the
    Ethier-Steinman problem's exact fields are float64 under it, which a
    float32 run cannot carry (as the reference's float32 CLI runs)."""
    code = textwrap.dedent(
        """
        import sys
        sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
        import jax
        jax.config.update("jax_platforms", "cpu")
        import numpy as np
        import chip_smoke
        from test_torch_slice_f32 import jax_geometry
        from test_torch_port_copies import jax_config
        from navierstokes_project_nm4pde_tpu import models
        geom, spec, steps, _ = chip_smoke.SMALL_CHECKS[sys.argv[2]]
        js = models.NavierStokesSolver(*jax_geometry(geom), jax_config(chip_smoke.small_config(spec, "float32")))
        st, d = js.run(steps)
        np.savez(sys.argv[3], u=st.u, p=st.p, c_d=d.c_d, c_l=d.c_l, delta_p=d.delta_p, iters=d.iters)
        """
    )
    path = tmp_path / "f32.npz"
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    res = subprocess.run(
        [sys.executable, "-c", code, str(REPO), name, str(path)],
        capture_output=True, text=True, timeout=600, env={**env, "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 0, res.stdout + res.stderr
    with np.load(path) as z:
        out = {k: np.asarray(z[k], np.float64) for k in ("u", "p", "c_d", "c_l", "delta_p")}
        return out, np.asarray(z["iters"])


@pytest.mark.parametrize("name", list(chip_smoke.SMALL_CHECKS))
def test_reference_float32_spread_is_within_half_the_card_tolerance(name, tmp_path):
    tol = chip_smoke.SMALL_CHECKS[name][3]
    (ref, it64), (out, it32) = (_run(name, dt, tmp_path) for dt in ("float64", "float32"))
    errs = chip_smoke.small_errors(out, ref)
    print(f"{name}: iters f64 {it64.tolist()} f32 {it32.tolist()}; "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert set(errs) >= {"u", "p"}
    assert max(errs.values()) <= tol / 2, errs
