"""How far the JAX package's own float32 run lies from its float64 run, for
each monolithic configuration `chip_smoke.py` checks on the card.

On the card the port runs float32 and is held to its CPU float64 run on
the small duct (chip_smoke.MONO_CHECKS).  The monolithic system mixes M/dt
with the pressure block, so float32 leaves a spread that the tolerance
must allow.  This test measures the reference's spread with the same
mesh, steps and measure as chip_smoke's `check_small_duct` (max error over
the steps relative to max |float64|; c_l relative to max |c_d|) and holds
it under half of each card tolerance, so the card is held to what the
reference itself achieves with a factor 2 for another summation order.
The spreads are printed (pytest -s).
"""

import warnings

import numpy as np
import pytest

import chip_smoke
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from test_torch_port_copies import jax_config


def _run(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ayosida and block_triangular at maxiter
        js = JaxSolver(jax_duct(**chip_smoke.SMALL_DUCT), JaxCylinder3D(test_case=2), jax_config(cfg))
        st, d = js.run(chip_smoke.AGREE_STEPS)
    out = {k: np.asarray(getattr(st, k), np.float64) for k in ("u", "p")}
    out.update({k: np.asarray(getattr(d, k), np.float64) for k in ("c_d", "c_l", "delta_p")})
    return out, np.asarray(d.iters)


@pytest.mark.parametrize("name", list(chip_smoke.MONO_CHECKS))
def test_reference_float32_spread_is_within_half_the_card_tolerance(name):
    changes, tol = chip_smoke.MONO_CHECKS[name]
    (ref, it64), (out, it32) = (_run(chip_smoke.cylinder3d_config(dt, **changes))
                                for dt in ("float64", "float32"))
    errs = {
        k: np.abs(out[k] - ref[k]).max() / np.abs(ref["c_d" if k == "c_l" else k]).max()
        for k in ref
    }
    print(f"{name}: iters f64 {it64.tolist()} f32 {it32.tolist()}; "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert max(errs.values()) <= tol / 2, errs
