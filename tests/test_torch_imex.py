"""The PyTorch port's explicit and IMEX convection against the JAX package.

Operators, on the small RCM duct `cylinder_duct_3d(lc=0.25, nz=3)` at
float64 with the same seeded numpy fields on both sides:

  * the constant K = M/dt + nu A assembled once (`build_velocity_kcsr`,
    applied per channel by `apply_csr_scalar`) against the reference's
    supernode BSR form (`build_velocity_kbsr`, `apply_bsr_scalar`): the
    same values summed in another order -> rtol 1e-11;
  * the explicit rhs N(w) = C(w)w (`apply_convection_self`), the IMEX fine
    subset's element matrices (`convection_fine_fold`) and apply
    (`apply_convection_fine`), the IMEX-weighted fold and the fused
    explicit-cell rhs (`convection_setup`, `apply_rhs_and_r0` with `w_e`):
    einsum summation order -> rtol 1e-12.

Runs: 3 steps of the port against the JAX solver on the benchmark
configuration with IMEX convection, on a genuinely mixed partition
(`cylinder_duct_3d(lc=0.22, nz=3)`, u_max 9, CFL 0.07, dt 1e-3, as the
reference's tests/test_imex.py) with K assembled and with the element
fallback, and with every cell implicit: equal F and S counts per step, u
and p to rtol 1e-8 / 1e-7 (tests/test_torch_slice.py's tolerances).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu.fem.geometry import cell_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.ops import bsr as jbsr
from navierstokes_project_nm4pde_tpu.ops import operators as jops
from navierstokes_project_nm4pde_tpu.ops.tables import build_ref_tables as jtables
from navierstokes_project_nm4pde_tpu_torch.fem import geometry as tgeometry
from navierstokes_project_nm4pde_tpu_torch.fem import space as tspace
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d as port_duct
from navierstokes_project_nm4pde_tpu_torch.ops import bsr as tbsr
from navierstokes_project_nm4pde_tpu_torch.ops import operators as tops
from navierstokes_project_nm4pde_tpu_torch.ops.tables import build_ref_tables as ttables
from test_torch_projection_variants import assert_same_run, run_both, variant_config

F64 = torch.float64
NU, DT = 1e-3, 2e-4
MIXED = dict(lc=0.22, nz=3)
IMEX_RUNS = {
    # name -> (config changes, mesh)
    "mixed": ({"time": dict(convection="imex", imex_umax=9.0, imex_cfl=0.07, dt=1e-3)}, MIXED),
    "mixed, element F": (
        {"time": dict(convection="imex", imex_umax=9.0, imex_cfl=0.07, dt=1e-3),
         "numerics": dict(vel_apply="element")}, MIXED,
    ),
    "all implicit": ({"time": dict(convection="imex", imex_umax=1e9)}, dict(lc=0.25, nz=3)),
}


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(a, b, rtol, atol_scale=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_scale * max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def duct():
    """Both packages' operators on the small RCM duct, each on its own
    package's mesh, space and geometry, and a partition of the cells."""
    space = build_taylor_hood(cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm"))
    geom = cell_geometry(space)
    tsp = tspace.build_taylor_hood(port_duct(lc=0.25, nz=3).reorder_spatial("rcm"))
    tgeom = tgeometry.cell_geometry(tsp)
    jop = jops.build_operator(space, geom, space.dirichlet_mask([0, 2, 3]), dtype=jnp.float64)
    top, _ = tops.build_operator(tsp, tgeom, tsp.dirichlet_mask([0, 2, 3]), F64, "cpu")
    rng = np.random.default_rng(0)
    fields = {k: rng.normal(size=(space.n_unodes, 3)) for k in ("u", "w", "hist", "u0")}
    fields["p"] = rng.normal(size=space.n_pnodes)
    implicit = rng.random(space.cells_u.shape[0]) < 0.3
    return dict(space=space, geom=geom, jop=jop, tsp=tsp, tgeom=tgeom, top=top, f=fields,
                implicit=implicit)


def test_velocity_k_matches_reference_bsr(duct):
    """K on [n, 3] and on a [n, 12] block of velocities (the recycled
    GCR's wide round)."""
    kb = jbsr.build_velocity_kbsr(duct["space"], duct["geom"], jtables(3), NU, DT, bs=16,
                                  dtype=jnp.float64)
    kc = tbsr.build_velocity_kcsr(duct["tsp"], duct["tgeom"], ttables(3), NU, DT, F64, "cpu")
    u = duct["f"]["u"]
    wide = np.concatenate([u, duct["f"]["w"], duct["f"]["hist"], duct["f"]["u0"]], axis=1)
    for x in (u, wide):
        _close(tbsr.apply_csr_scalar(kc, _t(x)).numpy(), jbsr.apply_bsr_scalar(kb, jnp.asarray(x)), 1e-11)
    # and the element pass of the same K, conv=None
    _close(tops.apply_F(duct["top"], NU, DT, None, _t(u)).numpy(),
           jops.apply_F(duct["jop"], NU, DT, None, jnp.asarray(u)), 1e-12)


def test_convection_self_matches_reference(duct):
    w = duct["f"]["w"]
    _close(tops.apply_convection_self(duct["top"], _t(w)).numpy(),
           jops.apply_convection_self(duct["jop"], jnp.asarray(w)), 1e-12)


def test_fine_subset_matches_reference(duct):
    """convection_fine_fold and apply_convection_fine on a seeded subset of
    the cells; the subset's pass equals the weighted full pass."""
    cells = np.nonzero(duct["implicit"])[0]
    jim = jops.build_imex_tables(duct["space"], duct["geom"], cells, jnp.float64)
    tim = tops.build_imex_tables(duct["tsp"], duct["tgeom"], cells, F64, "cpu")
    assert tim.plans.n_slots == cells.size * 10
    w, u = duct["f"]["w"], duct["f"]["u"]
    jw_e = jops.gather_u(duct["jop"], jnp.asarray(w))
    tw_e = tops.gather_u(duct["top"], _t(w))
    jC = jops.convection_fine_fold(duct["jop"], jim, jw_e[jim.f_idx])
    tC = tops.convection_fine_fold(duct["top"], tim, tw_e[tim.f_idx])
    _close(tC.numpy(), jC, 1e-12)
    ty = tops.apply_convection_fine(tim, tC, _t(u))
    _close(ty.numpy(), jops.apply_convection_fine(duct["jop"], jim, jC, jnp.asarray(u)), 1e-12)
    # = the fold's convection weighted by the partition, minus K
    top = dataclasses.replace(duct["top"], imex_scale=_t(duct["implicit"].astype(float)))
    conv = tops.convection_setup(top, _t(w), fold=(NU, DT))
    full = tops.apply_F(top, NU, DT, conv, _t(u)) - tops.apply_F(top, NU, DT, None, _t(u))
    _close(ty.numpy(), full.numpy(), 1e-10, atol_scale=1e-11)


def test_imex_weighted_fold_and_rhs_match_reference(duct):
    """The IMEX-weighted fold, its diagonal and the element rhs pass with
    the explicit cells' -(1 - s) N(w) fused in."""
    s = duct["implicit"].astype(float)
    jop = dataclasses.replace(duct["jop"], imex_scale=jnp.asarray(s))
    top = dataclasses.replace(duct["top"], imex_scale=_t(s))
    f = duct["f"]
    jconv = jops.convection_setup(jop, jnp.asarray(f["w"]), fold=(NU, DT))
    tconv = tops.convection_setup(top, _t(f["w"]), fold=(NU, DT))
    _close(tconv.F_e.numpy(), jconv.F_e, 1e-12)
    _close(tconv.diagC.numpy(), jconv.diagC, 1e-12)
    jw_e = jops.gather_u(jop, jnp.asarray(f["w"]))
    jb, jr = jops.apply_rhs_and_r0(jop, jnp.asarray(f["hist"]), jnp.asarray(f["p"]), NU, DT, jconv,
                                   jnp.asarray(f["u0"]), w_e=jw_e)
    tb, tr = tops.apply_rhs_and_r0(top, _t(f["hist"]), _t(f["p"]), NU, DT, tconv, _t(f["u0"]),
                                   w_e=tops.gather_u(top, _t(f["w"])))
    _close(tb.numpy(), jb, 1e-12)
    _close(tr.numpy(), jr, 1e-12)
    # the K/C split's convection-only fold is the full fold less K
    tonly = tops.convection_setup(top, _t(f["w"]), fold=(NU, DT), conv_only=True)
    K_e = top.MHAT[None] * (top.detJ / DT)[:, None, None] + NU * top.stiff_e
    _close(tonly.F_e.numpy(), (tconv.F_e - K_e).numpy(), 1e-10, atol_scale=1e-12)
    with pytest.raises(ValueError, match="conv_only"):
        tops.apply_F(top, NU, DT, tonly, _t(f["u"]))


@pytest.fixture(scope="module")
def runs():
    return {
        name: run_both(variant_config(ch), mesh_kw) for name, (ch, mesh_kw) in IMEX_RUNS.items()
    }


@pytest.mark.parametrize("name", list(IMEX_RUNS))
def test_imex_run_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_run(jst, jd, tst, td)


def test_imex_partitions_match_reference(runs):
    """The mixed partition is mixed, the same cells on both sides; the
    fast path holds K and the fine subset, the fallback neither."""
    from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
    from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
    from test_torch_port_copies import jax_config

    mixed = runs["mixed"][2]
    assert 0.0 < mixed.imex_frac < 1.0
    assert mixed.kcsr is not None and mixed.imex is not None and mixed.f_apply == "element"
    js = JaxSolver(cylinder_duct_3d(**MIXED), JaxCylinder3D(test_case=2), jax_config(mixed.config))
    assert mixed.imex_frac == js._imex_frac
    np.testing.assert_array_equal(mixed.op.imex_scale.numpy(), np.asarray(js.op.imex_scale))
    fall = runs["mixed, element F"][2]
    assert fall.kcsr is None and fall.imex is not None
    assert runs["all implicit"][2].imex_frac == 1.0
