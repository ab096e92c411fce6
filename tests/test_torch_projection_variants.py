"""The PyTorch port's projection-stepper variants against the JAX solver.

Each variant is the benchmark configuration (chip_smoke.bench_config, the
one tests/test_torch_slice.py runs) with the knobs of `VARIANTS` turned,
run for 3 steps at float64 on the small DFG duct `cylinder_duct_3d(lc=0.25,
nz=3)` by both packages.  With equal per-step F and S iteration counts the
two differ by summation order only, so u and p are held to rtol 1e-8 /
1e-7 (the tolerances of tests/test_torch_slice.py).  The Krylov pieces the
variants add (`ls_warmstart`, `gcr_recycled`, `fgmres(aux=True)`) and the
two-level forms (`twolevel_apply_g`, `inv_solve_c`) are held to the JAX
functions on the same seeded numpy inputs.  The IMEX variants and their
operators are in tests/test_torch_imex.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.ops import coarse as jcoarse
from navierstokes_project_nm4pde_tpu.solvers import krylov as jkrylov
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
    state_from_numpy,
    state_to_numpy,
)
from navierstokes_project_nm4pde_tpu_torch.ops import coarse as tcoarse
from navierstokes_project_nm4pde_tpu_torch.solvers import krylov as tkrylov
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
# variant -> {config part: {field: value}}
VARIANTS = {
    "explicit": {"time": dict(convection="explicit")},
    "f_warmstart=2": {"precond": dict(f_warmstart=2)},
    "f_recycle=3": {"precond": dict(f_recycle=3)},
    "macro_split": {"numerics": dict(macro_split="on")},
    "f_apply=element+aux": {"numerics": dict(f_apply="element", div_apply="element", grad_apply="element")},
    "macro_rhs=off": {"numerics": dict(macro_rhs="off")},
    "macro_wfuse=off": {"numerics": dict(macro_wfuse="off")},
    "coarse_solve=inv": {"numerics": dict(coarse_solve="inv")},
    "mg2_form=v11": {"precond": dict(mg2_form="v11")},
}


def variant_config(changes, dtype="float64"):
    """chip_smoke's bench configuration with `changes`, the reference
    stepping one step per chunk."""
    cfg = chip_smoke.bench_config(dtype)
    changes = {**changes, "numerics": {"steps_per_chunk": 1, **changes.get("numerics", {})}}
    return dataclasses.replace(cfg, **{
        part: dataclasses.replace(getattr(cfg, part), **kw) for part, kw in changes.items()
    })


def run_both(cfg, mesh_kw, steps=STEPS):
    """(JAX state, JAX diagnostics, port solver, port state, port
    diagnostics) after `steps` steps from rest."""
    js = JaxSolver(jax_duct(**mesh_kw), JaxCylinder3D(test_case=2), jax_config(cfg))
    jst, jd = js.run(steps)
    ts = NavierStokesSolver(cylinder_duct_3d(**mesh_kw), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    tst, td = ts.run(steps)
    return jst, jd, ts, tst, td


def assert_same_run(jst, jd, tst, td):
    """Equal F and S counts step for step; u, p and the functionals to the
    summation-order tolerances."""
    np.testing.assert_array_equal(td.iters_f, np.asarray(jd.iters_f))
    np.testing.assert_array_equal(td.iters_s, np.asarray(jd.iters_s))
    ju, jp = np.asarray(jst.u), np.asarray(jst.p)
    np.testing.assert_allclose(tst.u.numpy(), ju, rtol=1e-8, atol=1e-10 * np.abs(ju).max())
    np.testing.assert_allclose(tst.p.numpy(), jp, rtol=1e-7, atol=1e-9 * np.abs(jp).max())
    np.testing.assert_allclose(td.c_d, np.asarray(jd.c_d), rtol=1e-8)


@pytest.fixture(scope="module")
def runs():
    """Every variant's 3-step runs, computed once for the module."""
    return {
        name: run_both(variant_config(ch), dict(lc=0.25, nz=3))
        for name, ch in VARIANTS.items()
    }


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_reference(runs, name):
    jst, jd, ts, tst, td = runs[name]
    assert_same_run(jst, jd, tst, td)
    assert np.all(td.iters_f < 60) and np.all(td.iters_s < 60)


def test_variants_take_their_paths(runs):
    """Each variant resolves to the path it names."""
    assert runs["explicit"][2].kcsr is not None and runs["explicit"][2].f_apply == "element"
    el = runs["f_apply=element+aux"][2]
    assert el.aux_div and el.op.div is None and el.op.grad is None
    assert not runs["macro_rhs=off"][2].macro_rhs
    assert runs["macro_wfuse=off"][2].macro_rhs and not runs["macro_wfuse=off"][2].macro_wfuse
    assert runs["macro_split"][2].macro_split
    assert runs["coarse_solve=inv"][2].proj_schur.inv_c is not None
    assert runs["coarse_solve=inv"][2].proj_schur.cho_w is None


@pytest.mark.parametrize("name", ["f_warmstart=2", "f_recycle=3"])
def test_velocity_pools_carry_over(runs, name):
    """fpool / fwpool go through state_to_numpy / state_from_numpy: the
    JAX state after 2 steps continues in the port as the JAX run does, and
    the port's state loads back unchanged."""
    cfg = variant_config(VARIANTS[name])
    js = JaxSolver(jax_duct(lc=0.25, nz=3), JaxCylinder3D(test_case=2), jax_config(cfg))
    st2, _ = js.run(2)
    st3, d3 = js.run(1, state=st2)
    ts = runs[name][2]
    pool = "fwpool" if name.startswith("f_warmstart") else "fpool"
    arrays = {k: None if getattr(st2, k, None) is None else np.asarray(getattr(st2, k))
              for k in ("u", "p", "t", "step", "u_prev", "p_prev", "u_prev2", "spool", "fpool", "fwpool")}
    assert arrays[pool] is not None and np.abs(arrays[pool]).max() > 0
    tst3, td3 = ts.run(1, state=state_from_numpy(arrays, "cpu"))
    assert_same_run(st3, d3, tst3, td3)
    np.testing.assert_allclose(
        getattr(tst3, pool).numpy(), np.asarray(getattr(st3, pool)),
        rtol=1e-6, atol=1e-8 * np.abs(np.asarray(getattr(st3, pool))).max(),
    )
    back = state_from_numpy(state_to_numpy(tst3), "cpu")
    assert torch.equal(getattr(back, pool), getattr(tst3, pool))
    # a state without the pool gets a zero pool, as the reference's does
    missing = dict(arrays, **{pool: None})
    st_z, _ = ts.run(1, state=state_from_numpy(missing, "cpu"))
    assert getattr(st_z, pool).shape == arrays[pool].shape


ENSEMBLE_REFUSES = [
    ("time.convection", {"time": dict(convection="explicit")}),
    ("time.convection", {"time": dict(convection="imex", imex_umax=9.0)}),
    ("precond.mg2_form", {"precond": dict(mg2_form="v11")}),
    ("precond.f_recycle", {"precond": dict(f_recycle=2)}),
    ("precond.f_warmstart", {"precond": dict(f_warmstart=2)}),
    ("numerics.coarse_solve", {"numerics": dict(coarse_solve="inv")}),
    ("numerics.f_apply", {"numerics": dict(f_apply="element")}),
    ("numerics.macro_rhs", {"numerics": dict(macro_rhs="off")}),
    ("numerics.macro_wfuse", {"numerics": dict(macro_wfuse="off")}),
    ("numerics.macro_split", {"numerics": dict(macro_split="on")}),
    ("numerics.grad_apply", {"numerics": dict(grad_apply="element")}),
    ("numerics.div_apply", {"numerics": dict(div_apply="element")}),
]
ENSEMBLE_NUS = (1e-3, 2e-3)


@pytest.mark.parametrize("name,changes", ENSEMBLE_REFUSES)
def test_ensemble_step_refuses_each_variant(name, changes):
    """Each variant the ensemble step once refused now runs: every member
    equals the single run with its nu (the same F and S counts, u and p to
    rtol 1e-8 / 1e-7), though the single run takes its macro, assembled-K
    and aux paths where the ensemble keeps the reference's element branch.
    The velocity warm-start pool is the exception, as in the reference's
    vmapped step: the ensemble carries it unused (zero), so its members
    equal the single run without it.  The JAX run_ensemble comparisons of
    these variants are in tests/test_torch_ensemble_*.py."""
    cfg = chip_smoke.with_changes(chip_smoke.ensemble_config("float64"), changes)
    mesh = cylinder_duct_3d(lc=0.25, nz=3)
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg, device="cpu")
    state = solver.initial_state(len(ENSEMBLE_NUS))
    nu = torch.tensor(ENSEMBLE_NUS, dtype=torch.float64)
    rows = []
    for _ in range(2):
        state, dg = solver.step(state, nu)
        rows.append(dg)
    if name == "precond.f_warmstart":
        assert torch.count_nonzero(state.fwpool) == 0
        cfg = chip_smoke.with_changes(cfg, {"precond": dict(f_warmstart=0)})
    for m, nu_m in enumerate(ENSEMBLE_NUS):
        single = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2, nu=nu_m), cfg, device="cpu")
        st, d = single.run(2)
        for k in ("iters_f", "iters_s"):
            np.testing.assert_array_equal(getattr(d, k), [r[k][m] for r in rows])
        u = state.u[..., m].numpy()
        np.testing.assert_allclose(st.u.numpy(), u, rtol=1e-8, atol=1e-10 * np.abs(u).max())
        p = state.p[..., m].numpy()
        np.testing.assert_allclose(st.p.numpy(), p, rtol=1e-7, atol=1e-9 * np.abs(p).max())


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _system(n=60, seed=0):
    """A seeded nonsymmetric, diagonally dominant system (A, b)."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.normal(size=(n, n)) / np.sqrt(n)
    return A, rng.normal(size=n)


def test_ls_warmstart_matches_reference():
    A, b = _system()
    rng = np.random.default_rng(1)
    D = rng.normal(size=(3, 60))
    Y = D @ A.T  # rows A d
    for Dk, Yk in ((D, Y), (np.zeros_like(D), np.zeros_like(Y))):
        jx, jr = jkrylov.ls_warmstart(jnp.asarray(Dk), jnp.asarray(Yk), jnp.asarray(b))
        tx, tr = tkrylov.ls_warmstart(_t(Dk), _t(Yk), _t(b))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("pool,tol_mode", [("zero", "r0"), ("span", "r0"), ("span", "abs")])
def test_gcr_recycled_matches_reference(pool, tol_mode):
    """A zero pool, a pool that spans most of the solution, and an
    absolute tolerance: same x, rounds and pool rows as the reference."""
    A, b = _system()
    rng = np.random.default_rng(2)
    if pool == "zero":
        P = np.zeros((3, 60))
    else:
        x = np.linalg.solve(A, b)
        P = np.stack([x + 1e-3 * rng.normal(size=60), rng.normal(size=60), np.zeros(60)])
    minv = 1.0 / np.diag(A)
    kw = dict(rtol=1e-9, atol=1e-8 if tol_mode == "abs" else 0.0, tol_mode=tol_mode, max_narrow=40)
    jx, jinfo, jD = jkrylov.gcr_recycled(
        lambda V: jnp.asarray(A) @ V, jnp.asarray(b), lambda V: jnp.asarray(minv)[:, None] * V,
        jnp.asarray(P), **kw,
    )
    At, mt = _t(A), _t(minv)
    tx, tinfo, tD = tkrylov.gcr_recycled(lambda V: At @ V, _t(b), lambda V: mt[:, None] * V, _t(P), **kw)
    assert tinfo.iters == int(jinfo.iters)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), rtol=1e-8, atol=1e-10)
    assert np.linalg.norm(b - A @ tx.numpy()) <= max(1e-9 * np.linalg.norm(b), kw["atol"]) * 1.01


def test_fgmres_aux_matches_reference():
    """fgmres(aux=True) returns f(x) for a linear f (here a fixed matrix P
    on the iterate), combined from the iterations as the reference does,
    over restarts."""
    A, b = _system(80, seed=3)
    P = np.random.default_rng(4).normal(size=(5, 80))
    kw = dict(rtol=1e-10, restart=6, maxiter=60)
    jx, jinfo, jaux = jkrylov.fgmres(
        lambda z: (jnp.asarray(A) @ z, jnp.asarray(P) @ z), jnp.asarray(b), aux=True, **kw
    )
    At, Pt = _t(A), _t(P)
    tx, tinfo, taux = tkrylov.fgmres(lambda z: (At @ z, Pt @ z), _t(b), aux=True, **kw)
    assert tinfo.iters == int(jinfo.iters) and tinfo.iters > 6
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(taux.numpy(), P @ tx.numpy(), rtol=1e-9, atol=1e-12)


def test_twolevel_v11_and_inverse_coarse_solve_match_reference():
    """twolevel_apply_g (V(1,1) and without the post-smoothing) with the
    inverse coarse solve, on a seeded SPD S and aggregates of 7 nodes."""
    rng = np.random.default_rng(5)
    n, agg = 50, 7
    Q = rng.normal(size=(n, n))
    S = Q @ Q.T / n + np.eye(n)
    cs_t = tcoarse.build_coarse_schur(n, agg)
    nc = cs_t.nc
    jcs = jcoarse.CoarseSchur(plan=None, nc=nc, agg=agg, n_pad=nc * agg)
    R = np.zeros((nc, n))
    R[np.arange(n) // agg, np.arange(n)] = 1.0
    Sc_inv = np.linalg.inv(R @ S @ R.T)
    r = rng.normal(size=n)
    inv_d = 1.0 / np.diag(S)
    for post in (True, False):
        jz = jcoarse.twolevel_apply_g(
            jcs, jcoarse.inv_solve_c(jnp.asarray(Sc_inv)), lambda v: jnp.asarray(S) @ v,
            jnp.asarray(inv_d), jnp.asarray(r), post=post,
        )
        tz = tcoarse.twolevel_apply_g(
            cs_t, tcoarse.inv_solve_c(_t(Sc_inv)), lambda v: _t(S) @ v, _t(inv_d), _t(r), post=post,
        )
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-12, atol=1e-13)
    rc = rng.normal(size=nc)
    np.testing.assert_allclose(
        tcoarse.inv_solve_c(_t(Sc_inv))(_t(rc)).numpy(),
        np.asarray(jcoarse.inv_solve_c(jnp.asarray(Sc_inv))(jnp.asarray(rc))), rtol=1e-13,
    )


def test_batched_krylov_matches_the_reference_under_vmap():
    """The batched solvers on [n, B] columns (B = 3, one column zero, one
    pool zero) against `jax.vmap` of the reference's: `gcr_recycled` and
    `cg_recycled` (per-member counts and solutions), `gmres_fixed` and
    `cg_fixed`; the zero column stays finite and leaves the others as
    their own solves."""
    import jax

    A, _ = _system()
    rng = np.random.default_rng(6)
    S = A @ A.T / 60.0 + np.eye(60)  # SPD for the CGs
    b = rng.normal(size=(60, 3))
    b[:, 1] = 0.0
    pool = rng.normal(size=(3, 2, 60))
    pool[2] = 0.0
    minv = 1.0 / np.diag(A)
    At, St, mt = _t(A), _t(S), _t(minv)
    kw = dict(rtol=1e-9, atol=0.0, tol_mode="r0", max_narrow=40)
    jx, jinfo, jD = jax.vmap(lambda bb, P: jkrylov.gcr_recycled(
        lambda V: jnp.asarray(A) @ V, bb, lambda V: jnp.asarray(minv)[:, None] * V, P, **kw))(
        jnp.asarray(b.T), jnp.asarray(pool))
    tx, tinfo, tD = tkrylov.gcr_recycled(
        lambda V: torch.einsum("ij,jkb->ikb", At, V), _t(b), lambda V: mt[:, None, None] * V,
        _t(pool).permute(1, 2, 0), **kw)
    np.testing.assert_array_equal(tinfo.iters, np.asarray(jinfo.iters))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx).T, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tD.numpy(), np.moveaxis(np.asarray(jD), 0, -1), rtol=1e-8, atol=1e-10)
    assert np.all(np.isfinite(tx.numpy())) and np.all(tx[:, 1].numpy() == 0.0)

    W = np.einsum("ij,bkj->bki", S, pool)  # exact images of the pools
    jx, jinfo, jh = jax.vmap(lambda bb, P, Q: jkrylov.cg_recycled(
        lambda v: jnp.asarray(S) @ v, bb, lambda v: v / jnp.asarray(np.diag(S)), None, P, Q,
        rtol=1e-10, maxiter=200))(jnp.asarray(b.T), jnp.asarray(pool), jnp.asarray(W))
    tx, tinfo, th = tkrylov.cg_recycled(
        lambda v: St @ v, _t(b), lambda v: v / _t(np.diag(S))[:, None], None,
        _t(pool).permute(1, 2, 0), _t(W).permute(1, 2, 0), rtol=1e-10, maxiter=200)
    np.testing.assert_array_equal(tinfo.iters, np.asarray(jinfo.iters))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx).T, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(th.numpy(), np.moveaxis(np.asarray(jh), 0, -1), rtol=1e-8, atol=1e-10)

    for name, fixed in (("gmres_fixed", (A, At)), ("cg_fixed", (S, St))):
        M, Mt = fixed
        ref = jax.vmap(lambda bb: getattr(jkrylov, name)(
            lambda v: jnp.asarray(M) @ v, bb, lambda v: jnp.asarray(minv) * v, iters=6))(jnp.asarray(b.T))
        out = getattr(tkrylov, name)(lambda V: Mt @ V, _t(b), lambda V: mt[:, None] * V, iters=6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref).T, rtol=1e-10, atol=1e-12)
        assert np.all(out[:, 1].numpy() == 0.0)
