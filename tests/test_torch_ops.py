"""The PyTorch port's modules against the JAX reference, on the CPU.

Same numpy inputs (seeded) go through the reference function and its port
counterpart at float64 on a small RCM-ordered duct.  Tolerances:

  * host tables (geometry, diagonals, S1 values and slot layout, coarse
    matrix, band blocks): the same numpy code on the same inputs -> exact,
    or rtol 1e-13 where one side ran on device arrays;
  * element operators: einsum summation order differs -> rtol 1e-12;
  * macro build / matvec: summation order -> rtol 1e-12;
  * macro applies against apply_F: two reductions in another order ->
    rtol 1e-11;
  * Krylov: identical algorithms in float64 -> equal iteration counts,
    solutions to rtol 1e-10.

Each package builds the mesh, space and geometry with its own modules
(equal arrays: tests/test_torch_port_copies.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu.fem.geometry import boundary_tables, cell_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.fem import geometry as tgeometry
from navierstokes_project_nm4pde_tpu_torch.fem import space as tspace
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d as port_duct
from navierstokes_project_nm4pde_tpu.ops import banded as jbanded
from navierstokes_project_nm4pde_tpu.ops import bsr as jbsr
from navierstokes_project_nm4pde_tpu.ops import coarse as jcoarse
from navierstokes_project_nm4pde_tpu.ops import functionals as jfn
from navierstokes_project_nm4pde_tpu.ops import macroblock as jmb
from navierstokes_project_nm4pde_tpu.ops import operators as jops
from navierstokes_project_nm4pde_tpu.ops import scatter as jscatter
from navierstokes_project_nm4pde_tpu.solvers import krylov as jkrylov
from navierstokes_project_nm4pde_tpu_torch.ops import banded as tbanded
from navierstokes_project_nm4pde_tpu_torch.ops import coarse as tcoarse
from navierstokes_project_nm4pde_tpu_torch.ops import functionals as tfn
from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as tmb
from navierstokes_project_nm4pde_tpu_torch.ops import operators as tops
from navierstokes_project_nm4pde_tpu_torch.ops import scatter as tscatter
from navierstokes_project_nm4pde_tpu_torch.solvers import krylov as tkrylov

F64 = torch.float64
NU, DT = 1e-3, 2e-4


@pytest.fixture(scope="module")
def duct():
    """Small RCM duct with both packages' operators and macro plans, each
    on its own package's mesh, space and geometry."""
    mesh = cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0, 2, 3])
    tsp = tspace.build_taylor_hood(port_duct(lc=0.25, nz=3).reorder_spatial("rcm"))
    tgeom = tgeometry.cell_geometry(tsp)
    jop, jhost = jops.build_operator(
        space, geom, mask, dtype=jnp.float64, coarse_agg=24,
        device_schur_assembly=False, want_host_schur=True,
    )
    top, thost = tops.build_operator(
        tsp, tgeom, tsp.dirichlet_mask([0, 2, 3]), F64, "cpu", coarse_agg=24
    )
    jmp = jmb.build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=128, c_blk=20,
        n_vertices=mesh.n_vertices,
    )
    tmp = tmb.build_macro_plan(tsp.cells_u, tsp.n_unodes, U=128, c_blk=20, device="cpu")
    rng = np.random.default_rng(0)
    fields = {
        k: rng.normal(size=(space.n_unodes, 3)) for k in ("u", "w", "hist", "u0")
    }
    fields["p"] = rng.normal(size=space.n_pnodes)
    return dict(
        mesh=mesh, space=space, geom=geom, mask=mask, jop=jop, jhost=jhost,
        tspace=tsp, tgeom=tgeom, top=top, thost=thost, jmp=jmp, tmp=tmp, f=fields,
    )


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(a, b, rtol, atol_scale=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=atol_scale * max(np.abs(b).max(), 1e-300)
    )


# ----------------------------------------------------------------------
# Host tables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("field", ["detJ", "Jinv", "GKd", "diagM", "diagA", "MHAT", "AHAT"])
def test_operator_geometry_matches_reference(duct, field):
    _close(getattr(duct["top"], field).numpy(), getattr(duct["jop"], field), 1e-13)


@pytest.mark.parametrize("key", ["vals1", "diag_slot", "srow", "scol", "smask", "D_cols", "D_vals"])
def test_frozen_schur_host_tables_match_reference(duct, key):
    np.testing.assert_array_equal(duct["thost"][key], duct["jhost"][key])


def test_coarse_and_band_match_reference(duct):
    jh, th = duct["jhost"], duct["thost"]
    jc, tc = duct["jop"].coarse, duct["top"].coarse
    assert (tc.nc, tc.agg, tc.n_pad) == (jc.nc, jc.agg, jc.n_pad)
    Sc_t = tcoarse.host_coarse_dense(th, th["vals1"], tc.nc, tc.agg)
    np.testing.assert_array_equal(
        Sc_t, jcoarse.host_coarse_dense(jh, jh["vals1"], jc.nc, jc.agg)
    )
    sm = th["smask"]
    n_p = duct["space"].n_pnodes
    jb = jbanded.build_banded_schur(
        jh["srow"][sm], jh["scol"][sm], jh["vals1"][sm], n_rows=n_p,
        dtype=jnp.float64,
    )
    tb = tbanded.build_banded_schur(
        th["srow"][sm], th["scol"][sm], th["vals1"][sm], n_rows=n_p,
        dtype=F64, device="cpu",
    )
    np.testing.assert_array_equal(tb.vals.numpy(), np.asarray(jb.vals))
    np.testing.assert_array_equal(tb.tiles.numpy(), np.asarray(jb.tiles))
    assert tb.n_tiles_pad == jb.n_tiles_pad
    p = duct["f"]["p"]
    _close(tbanded.banded_matvec(tb, _t(p)).numpy(), jbanded.banded_matvec(jb, jnp.asarray(p)), 1e-12)


def test_coarse_preconditioner_matches_reference(duct):
    th, tc = duct["thost"], duct["top"].coarse
    Sc = tcoarse.host_coarse_dense(th, th["vals1"], tc.nc, tc.agg)
    L = np.linalg.cholesky(Sc)
    diag = np.where(th["vals1"][th["diag_slot"]] > 0, th["vals1"][th["diag_slot"]], 1.0)
    r = duct["f"]["p"]
    z_ref = jcoarse.twolevel_apply_additive_g(
        duct["jop"].coarse, jcoarse.cho_solve_c((jnp.asarray(L), True)),
        jnp.asarray(1.0 / diag), jnp.asarray(r),
    )
    z = tcoarse.twolevel_apply_additive_g(
        tc, tcoarse.cho_solve_c(_t(L)), _t(1.0 / diag), _t(r)
    )
    _close(z.numpy(), z_ref, 1e-12)


# ----------------------------------------------------------------------
# Gather-sum plans, D and G
# ----------------------------------------------------------------------
def test_segment_plan_matches_gather_plan():
    rng = np.random.default_rng(4)
    n_rows = 50
    flat = rng.integers(0, n_rows + 1, size=400)  # row n_rows = dropped
    vals = rng.normal(size=(400, 3))
    ref = jscatter.apply_gather_plan(
        jscatter.build_gather_plan_grouped(
            flat, n_rows, thresholds=(1, 2, 4), drop_row=n_rows, mode="columns"
        ),
        jnp.asarray(vals),
    )
    out = tscatter.apply_segment_plan(
        tscatter.build_segment_plan(flat, n_rows, drop_row=n_rows, device="cpu"), _t(vals)
    )
    _close(out.numpy(), ref, 1e-13)
    groups = [np.array([3, 7, 9]), np.array([0, 12])]
    gv = rng.normal(size=(5, 3))
    ref_inj = jscatter.apply_inverse_map(
        jscatter.build_inverse_map(groups, 20), jnp.asarray(gv)
    )
    inj = tscatter.apply_inverse_map(tscatter.build_inverse_map(groups, 20, device="cpu"), _t(gv))
    np.testing.assert_array_equal(inj.numpy(), np.asarray(ref_inj))


def test_divergence_and_gradient_match_bsr(duct):
    sp, jh = duct["space"], duct["jhost"]
    dbsr = jbsr.build_divergence_bsr(jh, sp.n_unodes, sp.n_pnodes, bs=32, dtype=jnp.float64)
    gbsr = jbsr.build_gradient_bsr(jh, sp.n_unodes, sp.n_pnodes, bs=16, dtype=jnp.float64)
    u, p = duct["f"]["u"], duct["f"]["p"]
    _close(
        tops.apply_divergence(duct["top"], _t(u)).numpy(),
        jbsr.apply_bsr(dbsr, jnp.asarray(u))[:, 0], 1e-12,
    )
    _close(
        tops.apply_gradient(duct["top"], _t(p)).numpy(),
        jbsr.apply_bsr(gbsr, jnp.asarray(p)[:, None]), 1e-12,
    )


# ----------------------------------------------------------------------
# Element operators
# ----------------------------------------------------------------------
def test_convection_setup_and_apply_F_match_reference(duct):
    jop, top, f = duct["jop"], duct["top"], duct["f"]
    base = tops.conv_base(top)
    jconv = jops.convection_setup(jop, jnp.asarray(f["w"]), fold=(NU, DT))
    tconv = tops.convection_setup(top, _t(f["w"]), fold=(NU, DT), base_e=base)
    _close(tconv.F_e.numpy(), jconv.F_e, 1e-12)
    _close(tconv.diagC.numpy(), jconv.diagC, 1e-12, atol_scale=1e-12)
    _close(
        tops.apply_F(top, NU, DT, tconv, _t(f["u"])).numpy(),
        jops.apply_F(jop, NU, DT, jconv, jnp.asarray(f["u"])), 1e-12,
    )
    with pytest.raises(ValueError):
        tops.apply_F(top, NU, 2 * DT, tconv, _t(f["u"]))


# ----------------------------------------------------------------------
# Macro path (plain kernel versions on the CPU)
# ----------------------------------------------------------------------
def test_macro_plan_matches_reference(duct):
    jmp, tmp = duct["jmp"], duct["tmp"]
    assert (tmp.B, tmp.U, tmp.c_blk, tmp.E, tmp.n) == (jmp.B, jmp.U, jmp.c_blk, jmp.E, jmp.n)
    np.testing.assert_array_equal(tmp.uidx.numpy(), np.asarray(jmp.uidx))
    # the one-hot table of the reference is the local slot table, expanded
    onehot = np.asarray(jmp.onehot, np.float32)
    lidx = tmp.lidx.numpy()
    valid = np.arange(tmp.B * tmp.c_blk).reshape(tmp.B, tmp.c_blk) < tmp.E
    expect = (lidx[..., None] == np.arange(tmp.U)) & valid[:, :, None, None]
    np.testing.assert_array_equal(onehot, expect.astype(np.float32))


def test_macro_build_plain_matches_reference(duct):
    rng = np.random.default_rng(1)
    E = duct["tspace"].cells_u.shape[0]
    F_e = rng.normal(size=(E, 10, 10)) * 10.0 ** rng.uniform(-3, 3, size=(E, 1, 1))
    ref = jmb.build_macro_values(duct["jmp"], jnp.asarray(F_e), layout="vu")
    out = tmb.build_macro_values(duct["tmp"], _t(F_e))
    _close(out.numpy(), ref, 1e-12)


@pytest.mark.parametrize("C", [3, 6])
def test_macro_matvec_plain_matches_pallas(duct, C):
    """Against the Pallas kernel, run in interpret mode off the TPU as the
    reference's own tests run it."""
    jmp = duct["jmp"]
    rng = np.random.default_rng(10 + C)
    FtT = rng.normal(size=(jmp.B, jmp.U, jmp.U))
    u_b = rng.normal(size=(jmp.B, jmp.U, C))
    ref = jmb.macro_matvec_vpu(jnp.asarray(FtT), jnp.asarray(u_b))
    out = tmb.macro_matvec(_t(FtT), _t(u_b))
    _close(out.numpy(), ref, 1e-12)


def test_macro_applies_match_reference_and_apply_F(duct):
    jop, top, jmp, tmp, f = duct["jop"], duct["top"], duct["jmp"], duct["tmp"], duct["f"]
    jconv = jops.convection_setup(jop, jnp.asarray(f["w"]), fold=(NU, DT))
    tconv = tops.convection_setup(top, _t(f["w"]), fold=(NU, DT))
    Ft_j = jmb.build_macro_values(jmp, jconv.F_e)
    FtT = tmb.build_macro_values(tmp, tconv.F_e)
    u = f["u"]
    y = tmb.apply_macro(tmp, FtT, _t(u)).numpy()
    _close(y, jmb.apply_macro(jmp, Ft_j, jnp.asarray(u)), 1e-11)
    _close(y, jops.apply_F(jop, NU, DT, jconv, jnp.asarray(u)), 1e-11)

    Mt_j = jmb.build_macro_values(jmp, jop.MHAT[None] * jop.detJ[:, None, None])
    MtT = tmb.build_macro_mass(tmp, top.MHAT, top.detJ)
    Mh_j, Fu_j = jmb.apply_rhs_and_r0_macro(
        jmp, Mt_j, Ft_j, jnp.asarray(f["hist"]), jnp.asarray(f["u0"])
    )
    Mh, Fu = tmb.apply_rhs_and_r0_macro(tmp, MtT, FtT, _t(f["hist"]), _t(f["u0"]))
    _close(Mh.numpy(), Mh_j, 1e-11)
    _close(Fu.numpy(), Fu_j, 1e-11)
    _close(Fu.numpy(), jops.apply_F(jop, NU, DT, jconv, jnp.asarray(f["u0"])), 1e-11)


def test_slot_expand_elem_is_the_element_gather(duct):
    tmp, w = duct["tmp"], _t(duct["f"]["w"])
    w_e = tmb.slot_expand_elem(tmp, tmb.slot_gather(tmp, w))
    np.testing.assert_array_equal(w_e.numpy(), w[duct["top"].cells_u].numpy())


def test_macro_build_slot_check_runs_once_per_table():
    """Kernel B's wrapper reads a slot table back to check its range once,
    and again only after the table is written or U changes."""
    lidx = torch.tensor([[[0, 5, 9]]], dtype=torch.int32)
    tmb._check_slots("t", lidx, 10)
    assert lidx._slots_checked == (lidx._version, 10)
    with pytest.raises(ValueError):
        tmb._check_slots("t", lidx, 9)  # another U: checked again
    tmb._check_slots("t", lidx, 10)
    assert not hasattr(lidx.clone(), "_slots_checked")  # a copy is checked anew
    lidx[0, 0, 0] = 12  # written in place: checked again
    with pytest.raises(ValueError):
        tmb._check_slots("t", lidx, 10)


def test_cpu_path_launches_no_kernel(duct):
    tmb.reset_launch_counts()
    tmp = duct["tmp"]
    tmb.apply_macro(tmp, tmb.build_macro_mass(tmp, duct["top"].MHAT, duct["top"].detJ), _t(duct["f"]["u"]))
    assert tmb.launch_counts == {"macro_build": 0, "macro_matvec": 0}


# ----------------------------------------------------------------------
# Functionals
# ----------------------------------------------------------------------
def test_forces_and_probe_match_reference(duct):
    sp, geom, f = duct["space"], duct["geom"], duct["f"]
    tsp, tgeom = duct["tspace"], duct["tgeom"]
    bt = boundary_tables(sp, geom, degree=4)
    jft = jfn.build_force_tables(sp, bt, tag=3, dtype=jnp.float64)
    tft = tfn.build_force_tables(tsp, tgeometry.boundary_tables(tsp, tgeom, degree=4), 3, F64, "cpu")
    ref = jfn.forces_3d(jft, jnp.asarray(f["u"]), jnp.asarray(f["p"]), NU, 1.0)
    out = tfn.forces_3d(tft, _t(f["u"]), _t(f["p"]), NU, 1.0)
    for a, b in zip(out, ref):
        _close(float(a), float(b), 1e-12)
    pts = ((0.45, 0.2, 0.205), (0.55, 0.2, 0.205))
    jpr = jfn.build_point_probe(sp, geom, pts, dtype=jnp.float64)
    tpr = tfn.build_point_probe(tsp, tgeom, pts, F64, "cpu")
    _close(tpr.pressure(_t(f["p"])).numpy(), jpr.pressure(jnp.asarray(f["p"])), 1e-13)
    cd, cl = tfn.drag_lift_coefficients(out[0], out[1], 4.0, 0.1, 0.41)
    cd_j, cl_j = jfn.drag_lift_coefficients(ref[0], ref[1], 4.0, 0.1, 0.41)
    _close(float(cd), float(cd_j), 1e-12)
    _close(float(cl), float(cl_j), 1e-12)


# ----------------------------------------------------------------------
# Krylov
# ----------------------------------------------------------------------
def _system(n, seed, spd):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    A = A @ A.T + np.eye(n) if spd else A + 3.0 * np.eye(n)
    return A, rng.normal(size=n), rng.normal(size=n)


@pytest.mark.parametrize(
    "tol_mode,rtol,atol,warm",
    [("b", 1e-9, 0.0, False), ("abs", 0.0, 1e-7, True), ("r0", 1e-8, 0.0, True)],
)
def test_fgmres_matches_reference(tol_mode, rtol, atol, warm):
    A, b, x0 = _system(80, 5, spd=False)
    d = 1.0 / np.diag(A)
    kw = dict(rtol=rtol, atol=atol, restart=8, maxiter=200, precise=False, tol_mode=tol_mode)
    xr, ir = jkrylov.fgmres(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=lambda v: jnp.asarray(d) * v,
        x0=jnp.asarray(x0) if warm else None, **kw,
    )
    xt, it = tkrylov.fgmres(
        lambda v: _t(A) @ v, _t(b), M=lambda v: _t(d) * v,
        x0=_t(x0) if warm else None, **kw,
    )
    assert it.iters == int(ir.iters) > 8  # at least one restart
    _close(xt.numpy(), xr, 1e-10)
    _close(it.residual, float(ir.residual), 1e-6)


def test_cg_recycled_matches_reference():
    A, b, x0 = _system(90, 6, spd=True)
    rng = np.random.default_rng(7)
    D = np.stack([rng.normal(size=90), np.zeros(90)])  # one zero row: ignored
    W = D @ A.T
    d = 1.0 / np.diag(A)
    kw = dict(rtol=1e-9, atol=0.0, maxiter=200, precise=False)
    xr, ir, hr = jkrylov.cg_recycled(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), lambda v: jnp.asarray(d) * v,
        jnp.asarray(x0), jnp.asarray(D), jnp.asarray(W), **kw,
    )
    xt, it, ht = tkrylov.cg_recycled(
        lambda v: _t(A) @ v, _t(b), lambda v: _t(d) * v, _t(x0), _t(D), _t(W), **kw,
    )
    assert it.iters == int(ir.iters) > 0
    _close(xt.numpy(), xr, 1e-10)
    _close(ht.numpy(), hr, 1e-10, atol_scale=1e-10)
