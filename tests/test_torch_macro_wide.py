"""The port's macro path at wide blocks (numerics.macro_u past 128) against
the JAX package, on the CPU.

The JAX package runs any macro block width U (its plan switches the slot
table to int16 above 128; its profile measured U = 192 and 256 at c_blk 34
and 48).  Here the port's plan, block build and macro applies at U = 192,
256 and 384 are held against the JAX `build_macro_plan`,
`build_macro_values`, `macro_matvec_vpu` (the Pallas kernel in interpret
mode, as the JAX package's own tests run it off the TPU) and `apply_macro`
on the same cells, and against the element apply `apply_F`, at float64 on
the small RCM duct of tests/test_torch_ops.py (and the build on the 2D
channel's triangles).  Same values summed in another order: rtol 1e-12.
Then 3 projection steps at macro_u=256, macro_cblk=48 through both solvers
(at the stepper's defaults, and with macro_split on and f_warmstart=5):
equal F and S counts, u and p to rtol 1e-8 / 1e-7 (the standard of
tests/test_torch_slice.py).  U = 2,560 at c_blk 256 (past the width at
which kernel A holds a block's whole input panel on the card) is held
against the JAX plan and `apply_F` the same way.  The plain kernel
versions run here; on the card tests/test_torch_kernels_cuda.py holds
kernels A and B at these widths, and wider, against them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu.fem.geometry import cell_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_channel_2d as jax_channel
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.ops import macroblock as jmb
from navierstokes_project_nm4pde_tpu.ops import operators as jops
from navierstokes_project_nm4pde_tpu_torch.fem import geometry as tgeometry
from navierstokes_project_nm4pde_tpu_torch.fem import space as tspace
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_channel_2d, cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as tmb
from navierstokes_project_nm4pde_tpu_torch.ops import operators as tops
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
NU, DT = 1e-3, 2e-4
RTOL = 1e-12
# name -> (U, c_blk): the JAX profile's two wide widths with its block
# sizes, and a width past kernel A's 256 columns a CTA
WIDTHS = {"U=192": (192, 34), "U=256": (256, 48), "U=384": (384, 48)}
STEPS = 3
TRAJECTORIES = {
    "defaults": {},
    "macro_split on, f_warmstart=5": {
        "numerics": dict(macro_rhs="on", macro_wfuse="on", macro_split="on"),
        "precond": dict(f_warmstart=5),
    },
}


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.fixture(scope="module")
def duct():
    """Both packages' operators on the small RCM duct, each on its own
    package's mesh, space and geometry, and seeded fields."""
    mesh = jax_duct(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    jop, _ = jops.build_operator(
        space, cell_geometry(space), space.dirichlet_mask([0, 2, 3]), dtype=jnp.float64,
        coarse_agg=24, device_schur_assembly=False, want_host_schur=True,
    )
    tsp = tspace.build_taylor_hood(cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm"))
    top, _ = tops.build_operator(
        tsp, tgeometry.cell_geometry(tsp), tsp.dirichlet_mask([0, 2, 3]), F64, "cpu", coarse_agg=24
    )
    rng = np.random.default_rng(0)
    fields = {k: rng.normal(size=(space.n_unodes, 3)) for k in ("u", "w", "hist", "u0")}
    return dict(mesh=mesh, space=space, jop=jop, tspace=tsp, top=top, f=fields)


@pytest.fixture(scope="module", params=list(WIDTHS))
def wide(request, duct):
    """Both packages' macro plans at one width, on the same cells."""
    U, c_blk = WIDTHS[request.param]
    space, tsp = duct["space"], duct["tspace"]
    jmp = jmb.build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=U, c_blk=c_blk,
        n_vertices=duct["mesh"].n_vertices,
    )
    tmp = tmb.build_macro_plan(tsp.cells_u, tsp.n_unodes, U=U, c_blk=c_blk, device="cpu")
    return dict(duct, jmp=jmp, tmp=tmp, U=U)


def _same_plan(jmp, tmp):
    assert (tmp.B, tmp.U, tmp.c_blk, tmp.E, tmp.n) == (jmp.B, jmp.U, jmp.c_blk, jmp.E, jmp.n)
    np.testing.assert_array_equal(tmp.uidx.numpy(), np.asarray(jmp.uidx))
    # the JAX one-hot table (int16 slot ids above 128) is the slot table, expanded
    lidx = tmp.lidx.numpy()
    valid = np.arange(tmp.B * tmp.c_blk).reshape(tmp.B, tmp.c_blk) < tmp.E
    expect = (lidx[..., None] == np.arange(tmp.U)) & valid[:, :, None, None]
    np.testing.assert_array_equal(np.asarray(jmp.onehot, np.float32), expect.astype(np.float32))


def test_wide_plan_matches_reference(wide):
    """The same blocks and c_blk after the auto-shrink, slots past 127."""
    _same_plan(wide["jmp"], wide["tmp"])
    assert int(wide["tmp"].lidx.max()) >= 128


def test_wide_build_matches_reference(wide):
    rng = np.random.default_rng(1)
    E = wide["tspace"].cells_u.shape[0]
    F_e = rng.normal(size=(E, 10, 10)) * 10.0 ** rng.uniform(-3, 3, size=(E, 1, 1))
    ref = jmb.build_macro_values(wide["jmp"], jnp.asarray(F_e), layout="vu")
    _close(tmb.build_macro_values(wide["tmp"], _t(F_e)).numpy(), ref)


@pytest.mark.parametrize("C", [3, 9])
def test_wide_matvec_matches_pallas(wide, C):
    jmp = wide["jmp"]
    rng = np.random.default_rng(10 + C)
    FtT = rng.normal(size=(jmp.B, jmp.U, jmp.U))
    u_b = rng.normal(size=(jmp.B, jmp.U, C))
    ref = jmb.macro_matvec_vpu(jnp.asarray(FtT), jnp.asarray(u_b))
    _close(tmb.macro_matvec(_t(FtT), _t(u_b)).numpy(), ref)


def test_wide_apply_matches_reference_and_apply_F(wide):
    jop, top, jmp, tmp, f = wide["jop"], wide["top"], wide["jmp"], wide["tmp"], wide["f"]
    jconv = jops.convection_setup(jop, jnp.asarray(f["w"]), fold=(NU, DT))
    tconv = tops.convection_setup(top, _t(f["w"]), fold=(NU, DT))
    y = tmb.apply_macro(tmp, tmb.build_macro_values(tmp, tconv.F_e), _t(f["u"])).numpy()
    _close(y, jmb.apply_macro(jmp, jmb.build_macro_values(jmp, jconv.F_e), jnp.asarray(f["u"])))
    _close(y, jops.apply_F(jop, NU, DT, jconv, jnp.asarray(f["u"])))


def test_wide_rhs_and_r0_matches_reference(wide):
    """The rhs/r0 pass: mass blocks on hist, F blocks on u0 and a
    warm-start pool's channels, one gather and one reduce."""
    jop, top, jmp, tmp, f = wide["jop"], wide["top"], wide["jmp"], wide["tmp"], wide["f"]
    jconv = jops.convection_setup(jop, jnp.asarray(f["w"]), fold=(NU, DT))
    tconv = tops.convection_setup(top, _t(f["w"]), fold=(NU, DT))
    Ft_j, FtT = jmb.build_macro_values(jmp, jconv.F_e), tmb.build_macro_values(tmp, tconv.F_e)
    Mt_j = jmb.build_macro_values(jmp, jop.MHAT[None] * jop.detJ[:, None, None])
    MtT = tmb.build_macro_mass(tmp, top.MHAT, top.detJ)
    extra = np.concatenate([f["w"], f["u"]], axis=1)
    ref = jmb.apply_rhs_and_r0_macro(
        jmp, Mt_j, Ft_j, jnp.asarray(f["hist"]), jnp.asarray(f["u0"]), extra=jnp.asarray(extra)
    )
    out = tmb.apply_rhs_and_r0_macro(tmp, MtT, FtT, _t(f["hist"]), _t(f["u0"]), extra=_t(extra))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        _close(o.numpy(), r)


def test_wide_blocks_on_triangles():
    """U = 256, c_blk 48 on the 2D channel's 6-node cells (the cylinder2d
    problem's macro path): plan, build and apply as the JAX package's."""
    jm = jax_channel(lc=0.12).reorder_spatial("rcm")
    jsp = build_taylor_hood(jm)
    tsp = tspace.build_taylor_hood(cylinder_channel_2d(lc=0.12).reorder_spatial("rcm"))
    assert tsp.cells_u.shape[1] == 6
    jmp = jmb.build_macro_plan(np.asarray(jsp.cells_u), jsp.n_unodes, U=256, c_blk=48,
                               n_vertices=jm.n_vertices)
    tmp = tmb.build_macro_plan(tsp.cells_u, tsp.n_unodes, U=256, c_blk=48, device="cpu")
    _same_plan(jmp, tmp)
    rng = np.random.default_rng(2)
    F_e = rng.normal(size=(tmp.E, 6, 6))
    Ft_j = jmb.build_macro_values(jmp, jnp.asarray(F_e), layout="vu")
    FtT = tmb.build_macro_values(tmp, _t(F_e))
    _close(FtT.numpy(), Ft_j)
    u = rng.normal(size=(tsp.n_unodes, 2))
    _close(tmb.apply_macro(tmp, FtT, _t(u)).numpy(),
           jmb.apply_macro(jmp, jmb.build_macro_values(jmp, jnp.asarray(F_e)), jnp.asarray(u)))


def test_very_wide_blocks_match_reference_and_apply_F(duct):
    """U = 2,560 at c_blk 256 (on the card kernel A stages such a block's
    input panel in chunks of rows, and kernel B builds it in row bands):
    the JAX package's plan, and the block build and apply against the JAX
    element apply `apply_F` at float64."""
    space, tsp, f = duct["space"], duct["tspace"], duct["f"]
    jmp = jmb.build_macro_plan(np.asarray(space.cells_u), space.n_unodes, U=2560, c_blk=256,
                               n_vertices=duct["mesh"].n_vertices)
    tmp = tmb.build_macro_plan(tsp.cells_u, tsp.n_unodes, U=2560, c_blk=256, device="cpu")
    _same_plan(jmp, tmp)
    assert tmp.c_blk == 256 and int(tmp.lidx.max()) >= 512
    jconv = jops.convection_setup(duct["jop"], jnp.asarray(f["w"]), fold=(NU, DT))
    tconv = tops.convection_setup(duct["top"], _t(f["w"]), fold=(NU, DT))
    y = tmb.apply_macro(tmp, tmb.build_macro_values(tmp, tconv.F_e), _t(f["u"])).numpy()
    _close(y, jops.apply_F(duct["jop"], NU, DT, jconv, jnp.asarray(f["u"])))


def _config(changes: dict):
    """chip_smoke's bench configuration (bench.py's defaults) at float64,
    one step a chunk, macro_u=256 and macro_cblk=48, with `changes`."""
    cfg = chip_smoke.bench_config("float64")
    cfg = dataclasses.replace(cfg, numerics=dataclasses.replace(
        cfg.numerics, steps_per_chunk=1, macro_u=256, macro_cblk=48))
    return chip_smoke.with_changes(cfg, changes)


@pytest.fixture(scope="module")
def runs():
    """Each trajectory's pair of runs, made at first use and shared."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = _config(TRAJECTORIES[name])
            js = JaxSolver(jax_duct(lc=0.22, nz=3), JaxCylinder3D(test_case=2), jax_config(cfg))
            jst, jd = js.run(STEPS)
            ts = NavierStokesSolver(
                cylinder_duct_3d(lc=0.22, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu"
            )
            tst, td = ts.run(STEPS)
            cache[name] = dict(js=js, ts=ts, jst=jst, jd=jd, tst=tst, td=td)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_wide_trajectory_runs_the_wide_plan(runs, name):
    r = runs(name)
    ts, js = r["ts"], r["js"]
    assert ts.f_apply == "macro" and ts.macro_rhs
    assert ts.macro_split == bool(TRAJECTORIES[name])
    assert (ts.macro.B, ts.macro.U, ts.macro.c_blk) == (js._macro.B, js._macro.U, js._macro.c_blk)
    assert ts.macro.U == 256


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_wide_trajectory_matches_reference_iteration_counts(runs, name):
    r = runs(name)
    np.testing.assert_array_equal(r["td"].iters_f, np.asarray(r["jd"].iters_f))
    np.testing.assert_array_equal(r["td"].iters_s, np.asarray(r["jd"].iters_s))
    assert np.all(r["td"].iters_f < r["ts"].config.solver.maxiter)


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_wide_trajectory_matches_reference_state(runs, name):
    r = runs(name)
    ju, jp = np.asarray(r["jst"].u), np.asarray(r["jst"].p)
    np.testing.assert_allclose(r["tst"].u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(r["tst"].p.numpy(), jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())
