"""The PyTorch port's block preconditioners and their pieces against the
JAX package, at float64.

Both packages set up the monolithic stepper on the small DFG duct
`cylinder_duct_3d(lc=0.25, nz=3)` (the same Morton node order) with
f_solver "pmg" and s_solver "spai_cg", so that each operator holds the
P2 -> P1 structure and the SPAI values.  On one seeded numpy convection
field w and one seeded residual (v_u, v_p), `apply_precond` is held to the
JAX function for all seven kinds and for every f_solver and s_solver value
it reads, to rtol 1e-10 of the largest entry: the two sides run the same
float64 algorithm and differ in summation order only.  With low_precision
(bfloat16 payloads) for each f_solver and for s_solver "mg2_cg", it is held
to a hundredth of one bfloat16 rounding step (RTOL_BF16).

The pieces are held to the JAX functions on the same inputs, to the same
rtol unless stated: `gmres_fixed`, `cg_fixed`, the three smoothers, the
per-step Schur ELL assembly, SpMV and diagonal (and the bfloat16 SpMV),
`coarse_factor` with `twolevel_apply`, `build_spai_values`, the PMG
transfers, coarse operator and coarse solve, and the constant blocks and
saddle-point operator of `ops/operators.py`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu import config as jconfig
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.models import Cylinder3DProblem as JaxCylinder3D
from navierstokes_project_nm4pde_tpu.models import NavierStokesSolver as JaxSolver
from navierstokes_project_nm4pde_tpu.ops import coarse as jcoarse
from navierstokes_project_nm4pde_tpu.ops import operators as jops
from navierstokes_project_nm4pde_tpu.ops import pmg as jpmg
from navierstokes_project_nm4pde_tpu.ops import schur_ell as jschur
from navierstokes_project_nm4pde_tpu.precond import blocks as jblocks
from navierstokes_project_nm4pde_tpu.solvers import krylov as jkrylov
from navierstokes_project_nm4pde_tpu.solvers import smoothers as jsmooth
from navierstokes_project_nm4pde_tpu_torch import config as tconfig
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.ops import coarse as tcoarse
from navierstokes_project_nm4pde_tpu_torch.ops import operators as tops
from navierstokes_project_nm4pde_tpu_torch.ops import pmg as tpmg
from navierstokes_project_nm4pde_tpu_torch.ops import schur_ell as tschur
from navierstokes_project_nm4pde_tpu_torch.precond import blocks as tblocks
from navierstokes_project_nm4pde_tpu_torch.solvers import krylov as tkrylov
from navierstokes_project_nm4pde_tpu_torch.solvers import smoothers as tsmooth
from test_torch_port_copies import jax_config, one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-10
NU, DT = 1e-3, 2e-4
BASE = dict(kind="yosida", f_iters=6, s_iters=30)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(out, ref, rtol=RTOL):
    ref = np.asarray(ref)
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def pair():
    """(JAX solver, port solver, seeded w, v_u, v_p, JAX conv, port conv)."""
    cfg = tconfig.RunConfig(
        time=tconfig.TimeConfig(dt=DT, t_end=4.0),
        precond=tconfig.PrecondConfig(**BASE, f_solver="pmg", s_solver="spai_cg"),
        numerics=tconfig.NumericsConfig(dtype="float64"),
    )
    js = JaxSolver(jax_duct(lc=0.25, nz=3), JaxCylinder3D(test_case=2), jax_config(cfg))
    ts = NavierStokesSolver(cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    np.testing.assert_array_equal(ts.space.unode_coords, js.space.unode_coords)
    rng = np.random.default_rng(0)
    n, n_p = ts.space.n_unodes, ts.space.n_pnodes
    w = rng.normal(size=(n, 3))
    v_u, v_p = rng.normal(size=(n, 3)), rng.normal(size=n_p)
    jconv = jops.convection_setup(js._dev.op, jnp.asarray(w), fold=(NU, DT), base_e=js._dev.conv_base)
    tconv = tops.convection_setup(ts.op, _t(w), fold=(NU, DT))
    return js, ts, w, v_u, v_p, jconv, tconv


# The PrecondConfig fields of each case (over BASE); f_lam=None runs the
# per-step power iteration instead of the set-up bound.
PRECOND_CASES = [
    *[dict(kind=k) for k in ("identity", "block_identity", "block_triangular", "simple",
                             "asimple", "yosida", "ayosida")],
    dict(kind="simple", alpha=0.5),
    dict(kind="yosida", f_corr_iters=2),
    *[dict(kind="yosida", f_solver=f) for f in ("richardson", "chebyshev", "pmg")],
    dict(kind="yosida", f_solver="chebyshev", f_lam=None),
    *[dict(kind="yosida", s_solver=s) for s in ("chebyshev", "mg2", "mg2_cg", "spai", "spai_cg")],
    dict(kind="asimple", f_solver="richardson", s_solver="mg2_cg"),
    dict(kind="block_triangular", f_solver="pmg"),
    # low_precision: bfloat16 payloads in every F apply and S~ SpMV
    *[dict(kind="yosida", f_solver=f, low_precision=True)
      for f in ("gmres", "richardson", "chebyshev", "pmg")],
    dict(kind="yosida", s_solver="mg2_cg", low_precision=True),
]
# low_precision cases: both sides round the same float64 values to
# bfloat16, so a value that lands within float64 rounding of a bfloat16 tie
# may round the other way on one side (one payload off by one bfloat16 step,
# 2^-8 relative).  Held to a hundredth of that step; the mode itself moves
# the application by 1.5e-2 to 6e-2 of its largest entry on these inputs,
# and the port stayed within 7e-12 of the JAX package's.
RTOL_BF16 = 2.0 ** -8 / 100


def _case_id(case):
    return ",".join(f"{k}={v}" for k, v in case.items())


@pytest.mark.parametrize("case", PRECOND_CASES, ids=_case_id)
def test_apply_precond_matches_reference(pair, case):
    js, ts, w, v_u, v_p, jconv, tconv = pair
    case = dict(case)
    f_lam = case.pop("f_lam", "setup")
    pc = tconfig.PrecondConfig(**{**BASE, **case})
    jpc = jconfig.PrecondConfig(**dataclasses.asdict(pc))
    j_lam, t_lam = (js._dev.f_lam0, ts._f_lam0) if f_lam == "setup" else (None, None)
    jst = jblocks.build_precond_state(
        js._dev.op, NU, DT, jconv, pc.kind, s_solver=pc.s_solver, f_solver=pc.f_solver, f_lam=j_lam,
    )
    tst = tblocks.build_precond_state(
        ts.op, NU, DT, tconv, pc.kind, s_solver=pc.s_solver, f_solver=pc.f_solver, f_lam=t_lam,
    )
    _close(tst.f_lam_max, jst.f_lam_max)
    _close(tst.schur_diag, jst.schur_diag)
    if pc.s_solver == "chebyshev":
        _close(tst.schur_lam_max, jst.schur_lam_max)
    jz_u, jz_p = jblocks.apply_precond(
        pc.kind, jpc, js._dev.op, jst, NU, DT, jnp.asarray(v_u), jnp.asarray(v_p)
    )
    tz_u, tz_p = tblocks.apply_precond(pc.kind, pc, ts.op, tst, NU, DT, _t(v_u), _t(v_p))
    rtol = RTOL_BF16 if pc.low_precision else RTOL
    _close(tz_u, jz_u, rtol)
    _close(tz_p, jz_p, rtol)


def test_inner_solves_read_nothing_back(pair, monkeypatch):
    """One yosida application (two fixed GMRES F solves and a fixed CG on
    S~) and the step's state never convert a tensor to a Python number."""
    _, ts, _, v_u, v_p, _, tconv = pair
    pc = tconfig.PrecondConfig(**BASE)

    def refuse(*a, **k):
        raise AssertionError("a host read in the preconditioner")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__float__", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    st = tblocks.build_precond_state(ts.op, NU, DT, tconv, "yosida", s_solver="cg", f_solver="gmres")
    z_u, _ = tblocks.apply_precond("yosida", pc, ts.op, st, NU, DT, _t(v_u), _t(v_p))
    assert z_u.shape == v_u.shape


def _system(n, seed, spd=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    A = A @ A.T + np.eye(n) if spd else np.eye(n) * 4.0 + A
    return A, rng.normal(size=n), 1.0 / np.diag(A)


@pytest.mark.parametrize("solver", ["gmres_fixed", "cg_fixed"])
def test_fixed_krylov_matches_reference(solver):
    A, b, dinv = _system(50, seed=3, spd=solver == "cg_fixed")
    for iters in (1, 6, 30):
        ref = getattr(jkrylov, solver)(
            lambda x: jnp.asarray(A) @ x, jnp.asarray(b), lambda x: jnp.asarray(dinv) * x, iters
        )
        out = getattr(tkrylov, solver)(lambda x: _t(A) @ x, _t(b), lambda x: _t(dinv) * x, iters)
        _close(out, ref)


@pytest.mark.parametrize("smoother", ["richardson", "chebyshev", "power"])
def test_smoothers_match_reference(smoother):
    A, b, dinv = _system(40, seed=4, spd=True)
    jA, jM = (lambda x: jnp.asarray(A) @ x), (lambda x: jnp.asarray(dinv) * x)
    tA, tM = (lambda x: _t(A) @ x), (lambda x: _t(dinv) * x)
    if smoother == "richardson":
        ref = jsmooth.richardson_fixed(jA, jnp.asarray(b), jM, iters=7, omega=0.6)
        out = tsmooth.richardson_fixed(tA, _t(b), tM, iters=7, omega=0.6)
    elif smoother == "chebyshev":
        ref = jsmooth.chebyshev_fixed(jA, jnp.asarray(b), jM, iters=7, lam_min=0.2, lam_max=3.0)
        out = tsmooth.chebyshev_fixed(tA, _t(b), tM, iters=7, lam_min=0.2, lam_max=3.0)
    else:
        v0 = np.sin(np.arange(40.0))
        ref = jsmooth.power_lambda_max(jA, jM, jnp.asarray(v0), iters=8)
        out = tsmooth.power_lambda_max(tA, tM, _t(v0), iters=8)
    _close(out, ref)


def test_schur_ell_assembly_matvec_and_diag_match_reference(pair):
    """The per-step S~ on the same slot layout: values slot for slot, the
    SpMV on one and on two columns, the diagonal, and the bfloat16 SpMV
    (bfloat16 products, float64 sums: to 1e-6 of the largest entry)."""
    js, ts, _, _, v_p, _, _ = pair
    inv = np.random.default_rng(5).uniform(0.5, 2.0, size=ts.space.n_unodes)
    jvals = jschur.assemble_schur_values(js._dev.op.schur, jnp.asarray(inv))
    tvals = tschur.assemble_schur_values(ts.op.schur, _t(inv))
    _close(tvals, jvals)
    # two columns at once, against the reference's one-vector SpMV each
    P = np.stack([v_p, np.cos(np.arange(v_p.size))], axis=1)
    out = tschur.schur_ell_matvec(ts.op.schur, tvals, _t(P))
    for c in range(2):
        _close(out[:, c], jschur.schur_ell_matvec(js._dev.op.schur, jvals, jnp.asarray(P[:, c])))
    _close(tschur.schur_ell_diag(ts.op.schur, tvals), jschur.schur_ell_diag(js._dev.op.schur, jvals))
    j16 = jschur.masked_bf16_vals(js._dev.op.schur, jvals)
    t16 = tschur.masked_bf16_vals(ts.op.schur, tvals)
    for a, b in zip(t16, j16):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    _close(tschur.schur_ell_matvec_bf16(ts.op.schur, t16, _t(v_p), torch.float64),
           jschur.schur_ell_matvec_bf16(js._dev.op.schur, j16, jnp.asarray(v_p), jnp.float64), rtol=1e-6)


@pytest.mark.parametrize("post", [True, False])
def test_coarse_factor_and_twolevel_apply_match_reference(pair, post):
    js, ts, _, _, v_p, _, _ = pair
    inv = np.random.default_rng(6).uniform(0.5, 2.0, size=ts.space.n_unodes)
    jvals = jschur.assemble_schur_values(js._dev.op.schur, jnp.asarray(inv))
    tvals = tschur.assemble_schur_values(ts.op.schur, _t(inv))
    jL = jcoarse.coarse_factor(js._dev.op.coarse, jvals)
    tL = tcoarse.coarse_factor(ts.op.coarse, tvals)
    _close(tcoarse.coarse_dense(ts.op.coarse, tvals), jcoarse.coarse_dense(js._dev.op.coarse, jvals))
    _close(tcoarse.coarse_inverse(ts.op.coarse, tvals), jcoarse.coarse_inverse(js._dev.op.coarse, jvals))
    jd = 1.0 / jschur.schur_ell_diag(js._dev.op.schur, jvals)
    td = 1.0 / tschur.schur_ell_diag(ts.op.schur, tvals)
    ref = jcoarse.twolevel_apply(
        js._dev.op.coarse, jL, lambda p: jschur.schur_ell_matvec(js._dev.op.schur, jvals, p),
        jd, jnp.asarray(v_p), post=post,
    )
    out = tcoarse.twolevel_apply(
        ts.op.coarse, tL, lambda p: tschur.schur_ell_matvec(ts.op.schur, tvals, p),
        td, _t(v_p), post=post,
    )
    _close(out, ref)


def test_spai_values_match_reference(pair):
    js, ts, *_ = pair
    _close(ts.op.spai_vals, js._dev.op.spai_vals)


def test_pmg_pieces_match_reference(pair):
    js, ts, _, v_u, _, _, _ = pair
    jp, tp = js._dev.op.pmg, ts.op.pmg
    jv, jinv = jpmg.pmg_vals(jp, NU, DT)
    tv, tinv = tpmg.pmg_vals(tp, NU, DT)
    _close(tv, jv)
    _close(tinv, jinv)
    jr = jpmg.restrict_p(jp, jnp.asarray(v_u))
    tr = tpmg.restrict_p(tp, _t(v_u))
    _close(tr, jr)
    _close(tpmg.pmg_matvec(tp, tv, tr), jpmg.pmg_matvec(jp, jv, jr))
    _close(tpmg.prolong_p(tp, tr, ts.space.n_unodes), jpmg.prolong_p(jp, jr, js.space.n_unodes))
    _close(tpmg.pmg_coarse_solve(tp, tv, tinv, tr, iters=6), jpmg.pmg_coarse_solve(jp, jv, jinv, jr, iters=6))


@pytest.mark.parametrize("operator", ["mass", "stiffness", "pressure_mass", "system", "system_unmasked"])
def test_constant_blocks_and_system_match_reference(pair, operator):
    js, ts, _, v_u, v_p, jconv, tconv = pair
    jop, top = js._dev.op, ts.op
    if operator == "mass":
        _close(tops.apply_mass(top, _t(v_u)), jops.apply_mass(jop, jnp.asarray(v_u)))
    elif operator == "stiffness":
        _close(tops.apply_stiffness(top, _t(v_u)), jops.apply_stiffness(jop, jnp.asarray(v_u)))
    elif operator == "pressure_mass":
        _close(tops.apply_pressure_mass(top, _t(v_p)), jops.apply_pressure_mass(jop, jnp.asarray(v_p)))
    else:
        mask_rows = operator == "system"
        ju, jp = jops.apply_system(jop, NU, DT, jconv, jnp.asarray(v_u), jnp.asarray(v_p), mask_rows=mask_rows)
        tu, tp = tops.apply_system(top, NU, DT, tconv, _t(v_u), _t(v_p), mask_rows=mask_rows)
        _close(tu, ju)
        _close(tp, jp)
