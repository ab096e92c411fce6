"""Block preconditioners for the saddle-point system (SIMPLE/Yosida family).

The counterpart of the reference's `precond/blocks.py`: `PRECOND_KINDS`,
`PrecondState` and `build_precond_state` (the per-step diagonals, the
assembled S~ with its Jacobi diagonal, spectral bound and coarse factor),
the inner solves `_solve_F` (fixed GMRES, Richardson, Chebyshev, or the
P2 -> P1 two-level correction) and `_solve_S` (fixed CG, Chebyshev, the
two-level mg2 / mg2_cg, SPAI / spai_cg), and `apply_precond` for every
kind.  With K = [[F, G], [D, 0]], G = -D^T, each kind replaces F^-1 in the
block LU factorisation by something cheaper:

  kind              S~ uses               inner solves
  ----------------- --------------------- -------------------------
  identity          --                    none
  block_identity    --                    none
  block_triangular  pressure mass Mp/nu   F solve, CG on Mp
  simple / asimple  D diag(F)^-1 D^T      F solve, S~ solve
  yosida            D (dt / diag M) D^T   2 F solves, S~ solve
  ayosida           D (dt / lump M) D^T   S~ solve only

Every inner solve runs a fixed number of iterations and reads nothing back
to the host, so one application costs no synchronisation.  On the card
each F apply is an element pass through kernels D and C.  `inv_diag_Fhat`
is the projection stepper's Jacobi diagonal.

Each application runs inside a span (`utils/profiling.py`:
`precond.apply`, with the sizes n_u, n_p, cols, itemsize), and each
inner solve inside its own (`precond.f_solve` with iters, rows, cols;
`precond.s_solve` with iters); with no profiler running a span costs one
flag check.

An ensemble passes nu as a [B] tensor and its fields with the members on
a trailing axis (v_u [n, dim, B], v_p [n_p, B]): the state then holds
what the reference's vmapped step builds per member (the diagonals, the
F bound by power iteration, S~'s values and coarse factor where S~'s
weight depends on nu), and shares what does not (yosida's and ayosida's
S~, the set-up SPAI values).
"""

from __future__ import annotations

import dataclasses

import torch

from navierstokes_project_nm4pde_tpu_torch.config import PrecondConfig
from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
from navierstokes_project_nm4pde_tpu_torch.ops.coarse import coarse_factor, twolevel_apply
from navierstokes_project_nm4pde_tpu_torch.ops.pmg import (
    pmg_coarse_solve,
    pmg_vals,
    prolong_p,
    restrict_p,
)
from navierstokes_project_nm4pde_tpu_torch.ops.schur_ell import (
    assemble_schur_values,
    masked_bf16_vals,
    schur_ell_diag,
    schur_ell_matvec,
    schur_ell_matvec_bf16,
)
from navierstokes_project_nm4pde_tpu_torch.solvers.krylov import cg_fixed, gmres_fixed
from navierstokes_project_nm4pde_tpu_torch.solvers.smoothers import (
    chebyshev_fixed,
    power_lambda_max,
    richardson_fixed,
)
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import span

PRECOND_KINDS = (
    "identity",
    "block_identity",
    "block_triangular",
    "simple",
    "asimple",
    "yosida",
    "ayosida",
)
F_SOLVERS = ("gmres", "richardson", "chebyshev", "pmg")
S_SOLVERS = ("cg", "chebyshev", "mg2", "mg2_cg", "spai", "spai_cg")


@dataclasses.dataclass
class PrecondState:
    """Per-step preconditioner data (rebuilt each step)."""

    diag_Fhat: torch.Tensor  # [n_unodes] diag of F with 1.0 on constrained rows
    inv_diag_Fhat: torch.Tensor  # [n_unodes]
    inv_diag_free: torch.Tensor  # [n_unodes] 1/diagF on free nodes, 0 constrained
    schur_inv: torch.Tensor  # [n_unodes] the weight inside S~ (kind-dependent)
    schur_vals: torch.Tensor | None  # [n_slots] per-step assembled S~ values
    schur_diag: torch.Tensor  # [n_pnodes] diag(S~) for Jacobi-CG
    schur_lam_max: torch.Tensor  # lam_max estimate of Jacobi-scaled S~ (Chebyshev)
    schur_cho_L: torch.Tensor | None  # lower Cholesky factor of the coarse matrix (mg2)
    f_lam_max: torch.Tensor  # lam_max estimate of Jacobi-scaled F (the smoothers)
    conv: ops.ConvectionData | None


def inv_diag_Fhat(op: ops.NSOperator, nu, dt, conv: ops.ConvectionData | None) -> torch.Tensor:
    """1 / diag(F) on free nodes, 1 on Dirichlet rows: [n_unodes], or
    [n_unodes, B] for a [B] tensor nu (an ensemble)."""
    dF = ops.diag_F(op, nu, dt, conv)
    return 1.0 / torch.where(_like(op.dirichlet_mask, dF), torch.ones_like(dF), dF)


def _like(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x [n] (or [n, d]) with trailing singleton axes to broadcast against
    v [n, *rest] (or [n, d, *rest])."""
    return x.reshape(x.shape + (1,) * (v.dim() - x.dim()))


def _flat(u: torch.Tensor) -> torch.Tensor:
    """[n, d, *rest] -> [n * d, *rest]."""
    return u.reshape(u.shape[0] * u.shape[1], *u.shape[2:])


def build_precond_state(
    op: ops.NSOperator, nu, dt, conv: ops.ConvectionData | None, kind: str,
    s_solver: str = "cg", f_solver: str = "gmres", f_lam: torch.Tensor | None = None,
    skip_schur: bool = False,
) -> PrecondState:
    """The step's preconditioner data.  `skip_schur=True` skips the S~
    assembly and coarse factorisation (the frozen projection Schur brings
    its own); only the velocity-block diagonals, `schur_inv` and the F
    bound are built."""
    dF = ops.diag_F(op, nu, dt, conv)
    mask = _like(op.dirichlet_mask, dF)
    one = torch.ones_like(dF)
    diag_Fhat = torch.where(mask, one, dF)
    inv_Fhat = 1.0 / diag_Fhat
    inv_free = torch.where(mask, torch.zeros_like(dF), 1.0 / dF)
    # yosida's and ayosida's S~ weights do not depend on nu: one S~ serves
    # every member
    zero = torch.zeros_like(op.diagM)
    if kind == "yosida":
        schur_inv = torch.where(op.dirichlet_mask, zero, dt / op.diagM)
    elif kind == "ayosida":
        schur_inv = torch.where(op.dirichlet_mask, zero, dt / op.lumpM)
    else:
        schur_inv = inv_free
    scalar = lambda v: torch.full((), v, dtype=dF.dtype, device=dF.device)  # noqa: E731
    f_lam_max = _f_lam_bound(op, nu, dt, conv, f_solver, f_lam, inv_Fhat)
    if skip_schur:
        return PrecondState(
            diag_Fhat=diag_Fhat, inv_diag_Fhat=inv_Fhat, inv_diag_free=inv_free,
            schur_inv=schur_inv, schur_vals=None, schur_diag=scalar(1.0),
            schur_lam_max=scalar(2.0), schur_cho_L=None, f_lam_max=f_lam_max, conv=conv,
        )

    # S~ in its pressure-space ELL pattern (the reference's per-step mmult)
    schur_vals = assemble_schur_values(op.schur, schur_inv)
    schur_diag = schur_ell_diag(op.schur, schur_vals)
    schur_diag = torch.where(schur_diag > 0, schur_diag, torch.ones_like(schur_diag))
    if s_solver == "chebyshev":
        inv_d = 1.0 / schur_diag
        v0 = torch.sin(torch.arange(op.n_pnodes, dtype=schur_diag.dtype, device=schur_diag.device))
        v0 = v0.reshape(-1, *(1,) * (schur_diag.dim() - 1)).expand(schur_diag.shape)
        lam_max = power_lambda_max(
            lambda p: schur_ell_matvec(op.schur, schur_vals, p), lambda p: inv_d * p, v0, iters=8,
        )
    else:
        lam_max = scalar(2.0)
    cho_L = coarse_factor(op.coarse, schur_vals) if s_solver.startswith("mg2") else None
    return PrecondState(
        diag_Fhat=diag_Fhat, inv_diag_Fhat=inv_Fhat, inv_diag_free=inv_free,
        schur_inv=schur_inv, schur_vals=schur_vals, schur_diag=schur_diag,
        schur_lam_max=lam_max, schur_cho_L=cho_L, f_lam_max=f_lam_max, conv=conv,
    )


def _f_lam_bound(op, nu, dt, conv, f_solver, f_lam, inv_Fhat):
    """Spectral bound lam_max(diag(F)^-1 F) for the damped smoothers: the
    set-up bound `f_lam` with a 1.1 margin plus twice max |diag C| / diag F,
    else (for a smoother) 6 power iterations on this step's F, else 2."""
    if f_lam is not None:
        f_lam = 1.1 * f_lam
        if conv is not None and conv.diagC is not None:
            f_lam = f_lam + 2.0 * torch.max(torch.abs(conv.diagC) * inv_Fhat)
        return f_lam
    if f_solver in ("richardson", "chebyshev", "pmg"):
        return f_lam_power(op, nu, dt, conv, inv_Fhat, iters=6)
    return torch.full((), 2.0, dtype=inv_Fhat.dtype, device=inv_Fhat.device)


def f_lam_power(op, nu, dt, conv, inv_Fhat: torch.Tensor, iters: int) -> torch.Tensor:
    """lam_max(diag(F)^-1 F) of F with Dirichlet identity rows (conv=None:
    the convection-free M/dt + nu A) by `iters` power iterations from
    sin(0, 1, ...): a 0-d tensor, or [B] for members (inv_Fhat [n, B]), no
    host sync."""
    n, d = op.n_unodes, op.dim
    shape = (n, d, *inv_Fhat.shape[1:])
    mask = op.dirichlet_mask.view(n, 1, *(1,) * (inv_Fhat.dim() - 1))

    def Fj(v):
        u = v.reshape(shape)
        return _flat(torch.where(mask, u, ops.apply_F(op, nu, dt, conv, u)))

    minv = _flat(inv_Fhat.unsqueeze(1).expand(shape))
    v0 = torch.sin(torch.arange(n * d, dtype=inv_Fhat.dtype, device=inv_Fhat.device))
    v0 = _like(v0, minv).expand(minv.shape)
    return power_lambda_max(Fj, lambda v: minv * v, v0, iters=iters)


# ----------------------------------------------------------------------
# Inner solves
# ----------------------------------------------------------------------
def _solve_F(op, st: PrecondState, nu, dt, rhs_u, cfg: PrecondConfig, iters=None):
    """Approximately solve F_hat z = rhs for rhs_u [n, dim] or members
    [n, dim, B] (f_solver: fixed GMRES, Richardson, Chebyshev, or the
    additive P2 -> P1 two-level correction); with cfg.low_precision the
    operator input is bfloat16."""
    it = iters if iters is not None else cfg.f_iters
    n, d = rhs_u.shape[:2]
    with span("precond.f_solve", iters=it, rows=n * d, cols=rhs_u.numel() // (n * d)):
        mask = _like(op.dirichlet_mask[:, None], rhs_u)
        dtype = rhs_u.dtype

        def Aflat(v):
            u = v.reshape(rhs_u.shape)
            x = u.to(torch.bfloat16) if cfg.low_precision else u
            y = ops.apply_F(op, nu, dt, st.conv, x).to(dtype)
            return _flat(torch.where(mask, u, y))

        Minv = _flat(st.inv_diag_Fhat.unsqueeze(1).expand(rhs_u.shape))
        b = _flat(rhs_u)
        if cfg.f_solver == "richardson":
            omega = cfg.omega / (0.5 * (1.0 + st.f_lam_max))
            z = richardson_fixed(Aflat, b, lambda v: Minv * v, iters=it, omega=omega)
        elif cfg.f_solver == "chebyshev":
            lam_max = 1.05 * st.f_lam_max
            z = chebyshev_fixed(
                Aflat, b, lambda v: Minv * v, iters=it, lam_min=lam_max / 8.0, lam_max=lam_max,
            )
        elif cfg.f_solver == "pmg":
            omega = cfg.omega / (0.5 * (1.0 + st.f_lam_max))
            cvals, inv_dc = pmg_vals(op.pmg, nu, dt)
            zc = pmg_coarse_solve(op.pmg, cvals, inv_dc, restrict_p(op.pmg, rhs_u), iters=it)
            dz = prolong_p(op.pmg, zc, n)
            z = omega * Minv * b + _flat(torch.where(mask, torch.zeros_like(dz), dz))
        else:
            z = gmres_fixed(Aflat, b, lambda v: Minv * v, iters=it)
        return z.reshape(rhs_u.shape)


def _solve_S(op, st: PrecondState, rhs_p, cfg: PrecondConfig):
    """Approximately solve S~ z = rhs on the assembled ELL form (s_solver:
    fixed CG, Chebyshev, the two-level mg2 / mg2_cg, or SPAI / spai_cg)."""
    single = cfg.s_solver in ("mg2", "spai")  # one application, no iteration
    with span("precond.s_solve", iters=0 if single else cfg.s_iters):
        if cfg.low_precision:
            vals16 = masked_bf16_vals(op.schur, st.schur_vals)

            def S(p):
                return schur_ell_matvec_bf16(op.schur, vals16, p, rhs_p.dtype)
        else:
            def S(p):
                return schur_ell_matvec(op.schur, st.schur_vals, p)

        if cfg.s_solver in ("mg2", "mg2_cg"):
            inv_d = 1.0 / st.schur_diag  # shared, or one a member: twolevel_apply spreads it

            def M2(v):
                return twolevel_apply(op.coarse, st.schur_cho_L, S, inv_d, v)

            if cfg.s_solver == "mg2":
                return M2(rhs_p)
            return cg_fixed(S, rhs_p, M2, iters=cfg.s_iters)

        if cfg.s_solver in ("spai", "spai_cg"):
            def Mspai(v):
                return schur_ell_matvec(op.schur, op.spai_vals, v)

            if cfg.s_solver == "spai":
                return Mspai(rhs_p)
            return cg_fixed(S, rhs_p, Mspai, iters=cfg.s_iters)

        Minv = _like(1.0 / st.schur_diag, rhs_p)
        if cfg.s_solver == "chebyshev":
            lam_max = 1.05 * st.schur_lam_max
            return chebyshev_fixed(
                S, rhs_p, lambda v: Minv * v, iters=cfg.s_iters,
                lam_min=lam_max / 30.0, lam_max=lam_max,
            )
        return cg_fixed(S, rhs_p, lambda v: Minv * v, iters=cfg.s_iters)


def _dt_apply(op, p):
    """D^T p in the velocity space (= -G p)."""
    return -ops.apply_gradient(op, p)


# ----------------------------------------------------------------------
# Application
# ----------------------------------------------------------------------
def apply_precond(kind: str, cfg: PrecondConfig, op, st: PrecondState, nu, dt, v_u, v_p):
    """z = P^-1 v for the preconditioner `kind`: (z_u [n, dim], z_p [n_p]),
    or members on a trailing axis."""
    if kind in ("identity", "block_identity"):
        return v_u, v_p
    with span("precond.apply", n_u=v_u.shape[0] * v_u.shape[1], n_p=v_p.shape[0],
              cols=v_p.numel() // v_p.shape[0], itemsize=v_u.element_size()):
        if kind == "block_triangular":
            # the full F block, then the nu-scaled pressure mass on v_p - D z_u
            z_u = _solve_F(op, st, nu, dt, v_u, cfg)
            rhs_p = v_p - ops.apply_divergence(op, z_u)
            MinvP = nu / _like(op.diagMp, v_p)
            z_p = cg_fixed(
                lambda p: ops.apply_pressure_mass(op, p) / nu, rhs_p, lambda v: MinvP * v,
                iters=cfg.s_iters,
            )
            return z_u, z_p

        if kind in ("simple", "asimple"):
            y_u = _solve_F(op, st, nu, dt, v_u, cfg)
            y_p = _solve_S(op, st, v_p - ops.apply_divergence(op, y_u), cfg)
            z_p = y_p / cfg.alpha
            return y_u + st.inv_diag_free.unsqueeze(1) * _dt_apply(op, z_p), z_p

        if kind == "yosida":
            # L-solve with S~ from dt M^-1, then a second F solve for the
            # velocity correction
            y_u = _solve_F(op, st, nu, dt, v_u, cfg)
            z_p = _solve_S(op, st, v_p - ops.apply_divergence(op, y_u), cfg)
            rhs_corr = _dt_apply(op, z_p)
            rhs_corr = torch.where(_like(op.dirichlet_mask[:, None], rhs_corr), torch.zeros_like(rhs_corr), rhs_corr)
            corr = _solve_F(op, st, nu, dt, rhs_corr, cfg, iters=cfg.f_corr_iters or None)
            return y_u + corr, z_p

        if kind == "ayosida":
            # every F solve a diagonal scaling; one CG on the lumped-mass S~
            y_u = st.inv_diag_Fhat.unsqueeze(1) * v_u
            z_p = _solve_S(op, st, v_p - ops.apply_divergence(op, y_u), cfg)
            return y_u + st.inv_diag_free.unsqueeze(1) * _dt_apply(op, z_p), z_p

    raise ValueError(f"unknown preconditioner kind: {kind}")
