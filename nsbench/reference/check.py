"""The comparison that decides `correct`, and the control stepper, for
each scheme that a configuration may state (`configs/*.json`
`run_config.time`), written from its equations.  Both are BDF1 steps with
implicit convection from (u^n, p^n) at viscosity nu and time step dt, with
F(w) = M / dt + nu K + C(w) and the reference's signs (the momentum rows
read F u - D^T p = ...; `fem.py`).

The projection stepper (`stepper` "projection"):

  1. u* = g on the Dirichlet nodes, and elsewhere
        F(u^n) u* = M u^n / dt + D^T p^n;
  2. S1 phi = -D u* / dt,   S1 = D diag(M)^-1 D^T  (diag(M)^-1 zero on the
     Dirichlet nodes);
  3. p^{n+1} = p^n + phi,   u^{n+1} = u* + dt diag(M)^-1 D^T phi,
     so that D u^{n+1} = 0;
  4. c_d, c_l and delta_p of (u^{n+1}, p^{n+1}).

The monolithic saddle-point stepper (`stepper` "monolithic"): one solve of

  F(u^n) u^{n+1} - D^T p^{n+1} = M u^n / dt   on the free rows,
  u^{n+1} = g                                 on the Dirichlet rows,
  D u^{n+1} = 0,

then c_d, c_l and delta_p of (u^{n+1}, p^{n+1}).

`step_numbers` judges a projection step that the program produced by what
it says: from the program's (u^n, p^n) and its (u^{n+1}, p^{n+1}, c_d, c_l,
delta_p) it rebuilds u* = u^{n+1} - dt diag(M)^-1 D^T phi and reads, in
float64 on the reference's own operators:

  mom   ||r|| / ||rhs||, r = F(u^n) u* - (M u^n / dt + D^T p^n) on the free
        rows and u* - g on the Dirichlet rows, rhs the same right-hand side
        with g on the Dirichlet rows (the solve of step 1);
  mom_row  the worst row of the same residual as a velocity: |r_i| over
        the row's diagonal of F (1 on a Dirichlet row), over max |u^{n+1}|
        (a fault at one node reads the same on any mesh);
  div   ||D u^{n+1}|| / ||D u*||  (steps 2 and 3: what the projection left);
  c_d, c_l   |c - c_ref| / |c_d ref|,  delta_p  |dp - dp_ref| / |dp_ref|
        (step 4, c_l on c_d's scale: it is near nought).

`monolithic_numbers` reads the same six names of a monolithic step, from
(u^{n+1}, p^{n+1}) as they stand:

  mom   ||r_u|| / ||rhs_u||, r_u = F(u^n) u^{n+1} - D^T p^{n+1} - M u^n / dt
        on the free rows and u^{n+1} - g on the Dirichlet rows, rhs_u =
        M u^n / dt with g on the Dirichlet rows;
  mom_row  the worst row of r_u as a velocity, as above;
  div   ||D u^{n+1}|| / || |D| |u^{n+1}| ||: the divergence over the same
        pass with every entry in absolute value (no cancellation), a
        dimensionless share that does not drift with the mesh;
  c_d, c_l, delta_p   as above.

The controls are the reference put in the program's place, each step
solved to the configuration's tolerances with every product in TF32
(`RefOperator(precision="tf32")`): `control_step` for the projection
stepper, `monolithic_control_step` for the monolithic one.  `SCHEMES`
pairs each stepper with its numbers and its control; `refuse_uncovered`
refuses a configuration that no pair covers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

NUMBERS = ("mom", "mom_row", "div", "c_d", "c_l", "delta_p")


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x.reshape(-1).to(torch.float64)))


def _rel(gap: float, scale: float) -> float:
    """gap / scale; infinite for a gap over a scale of nought."""
    if scale > 0.0:
        return gap / scale
    return 0.0 if gap == 0.0 else float("inf")


def step_numbers(ref, prob, u_n, p_n, u_new, p_new, diag: dict, nu: float, dt: float) -> dict:
    """The numbers of one step of one member (float64 reference `ref`)."""
    T = ref.T
    u_n, p_n, u_new, p_new = T(u_n), T(p_n), T(u_new), T(p_new)
    phi = p_new - p_n
    u_star = u_new - dt * ref.inv1[:, None] * ref.div_t(phi)
    mask = ref.mask[:, None]
    b = ref.mass(u_n) / dt + ref.div_t(p_n)
    F_e = ref.F_elements(nu, dt, u_n)
    Fu = ref.apply_elements(F_e, u_star)
    r = torch.where(mask, u_star - prob.g, Fu - b)
    scale = torch.where(ref.mask, torch.ones_like(ref.diagM), ref.diag_F(F_e))
    rhs = torch.where(mask, prob.g, b)
    d = prob.diagnostics(u_new, p_new, nu)
    return dict(
        mom=_rel(_norm(r), _norm(rhs)),
        mom_row=_rel(float((r / scale[:, None]).abs().max()), float(u_new.abs().max())),
        div=_rel(_norm(ref.div(u_new)), _norm(ref.div(u_star))),
        c_d=_rel(abs(diag["c_d"] - d["c_d"]), abs(d["c_d"])),
        c_l=_rel(abs(diag["c_l"] - d["c_l"]), abs(d["c_d"])),
        delta_p=_rel(abs(diag["delta_p"] - d["delta_p"]), abs(d["delta_p"])),
    )


def _functional_gaps(diag: dict, d: dict) -> dict:
    """The program's c_d, c_l, delta_p (`diag`) against the reference's
    (`d`): c_l on c_d's scale."""
    return dict(
        c_d=_rel(abs(diag["c_d"] - d["c_d"]), abs(d["c_d"])),
        c_l=_rel(abs(diag["c_l"] - d["c_l"]), abs(d["c_d"])),
        delta_p=_rel(abs(diag["delta_p"] - d["delta_p"]), abs(d["delta_p"])),
    )


def monolithic_numbers(ref, prob, u_n, p_n, u_new, p_new, diag: dict, nu: float, dt: float) -> dict:
    """The numbers of one monolithic step of one member (float64 reference
    `ref`); p^n does not enter the step's equations."""
    T = ref.T
    u_n, u_new, p_new = T(u_n), T(u_new), T(p_new)
    mask = ref.mask[:, None]
    b = ref.mass(u_n) / dt
    F_e = ref.F_elements(nu, dt, u_n)
    r = torch.where(mask, u_new - prob.g, ref.apply_elements(F_e, u_new) - ref.div_t(p_new) - b)
    scale = torch.where(ref.mask, torch.ones_like(ref.diagM), ref.diag_F(F_e))
    rhs = torch.where(mask, prob.g, b)
    return dict(
        mom=_rel(_norm(r), _norm(rhs)),
        mom_row=_rel(float((r / scale[:, None]).abs().max()), float(u_new.abs().max())),
        div=_rel(_norm(ref.div(u_new)), _norm(ref.div_abs(u_new))),
        **_functional_gaps(diag, prob.diagnostics(u_new, p_new, nu)),
    )


def worst(rows) -> dict:
    """The largest of each number over steps and members."""
    return {k: max(r[k] for r in rows) for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)


# ----------------------------------------------------------------------
# The control: the same step solved in TF32
# ----------------------------------------------------------------------
def gmres(A, b, x0, M, tol: float, restart: int, maxiter: int):
    """Right-preconditioned restarted GMRES on flat vectors until
    ||b - A x|| <= tol; returns (x, iterations)."""
    x = x0.clone()
    its = 0
    while its < maxiter:
        r = b - A(x)
        beta = torch.linalg.norm(r)
        if float(beta) <= tol:
            break
        V = [r / beta]
        Z = []
        H = torch.zeros((restart + 1, restart), dtype=b.dtype, device=b.device)
        k = 0
        for k in range(restart):
            z = M(V[k])
            w = A(z)
            for i in range(k + 1):
                H[i, k] = torch.dot(w, V[i])
                w = w - H[i, k] * V[i]
            H[k + 1, k] = torch.linalg.norm(w)
            Z.append(z)
            V.append(w / H[k + 1, k])
            its += 1
            e1 = torch.zeros(k + 2, dtype=b.dtype, device=b.device)
            e1[0] = beta
            y = torch.linalg.lstsq(H[: k + 2, : k + 1].cpu().double(), e1.cpu().double()[:, None]).solution
            res = float(torch.linalg.norm(H[: k + 2, : k + 1].cpu().double() @ y - e1.cpu().double()[:, None]))
            if res <= tol or its >= maxiter:
                break
        y = y.to(b.dtype).to(b.device)[:, 0]
        x = x + sum(y[i] * Z[i] for i in range(len(Z)))
        if res <= tol:
            break
    return x, its


def cg(A, b, x0, M, tol: float, maxiter: int):
    x = x0.clone()
    r = b - A(x)
    z = M(r)
    p = z.clone()
    rz = torch.dot(r, z)
    its = 0
    while float(torch.linalg.norm(r)) > tol and its < maxiter:
        Ap = A(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        its += 1
    return x, its


def control_step(ref, prob, u_n, p_n, nu: float, dt: float, solver: dict):
    """One step by the reference `ref` (precision "tf32" for the control),
    to the configuration's tolerances (`solver`: rtol against the
    right-hand side's norm, proj_div_cap, maxiter, restart); returns
    (u^{n+1}, p^{n+1}, diagnostics, iterations)."""
    T = ref.T
    u_n, p_n = T(u_n), T(p_n)
    n = ref.n_u
    mask = ref.mask[:, None]
    F_e = ref.F_elements(nu, dt, u_n)
    b = ref.mass(u_n) / dt + ref.div_t(p_n)
    rhs = torch.where(mask, prob.g, b).reshape(-1)

    def A(v):
        u = v.reshape(n, 3)
        return torch.where(mask, u, ref.apply_elements(F_e, u)).reshape(-1)

    dinv = torch.where(ref.mask, torch.ones_like(ref.diagM), 1.0 / ref.diag_F(F_e))
    dinv = dinv[:, None].expand(n, 3).reshape(-1)
    tol = solver["rtol"] * float(torch.linalg.norm(rhs))
    x0 = torch.where(mask, prob.g, u_n).reshape(-1)
    u_star, its_f = gmres(A, rhs, x0, lambda v: dinv * v, tol, solver["restart"], solver["maxiter"] * 10)
    u_star = u_star.reshape(n, 3)
    rhs_p = -ref.div(u_star) / dt
    d1 = ref.diag_S1()

    def S(q):
        return ref.div(ref.inv1[:, None] * ref.div_t(q))

    tol_p = min(tol / dt, solver["proj_div_cap"] * float(torch.linalg.norm(rhs_p)))
    phi, its_s = cg(S, rhs_p, torch.zeros_like(rhs_p), lambda q: q / d1, tol_p, 20000)
    p_new = p_n + phi
    u_new = u_star + dt * ref.inv1[:, None] * ref.div_t(phi)
    return u_new, p_new, prob.diagnostics(u_new, p_new, nu), (its_f, its_s)


# the pressure solve inside the monolithic control's preconditioner
PRECOND_RTOL = 1e-2
PRECOND_MAXITER = 500


def monolithic_control_step(ref, prob, u_n, p_n, nu: float, dt: float, solver: dict):
    """One monolithic step by the reference `ref` (precision "tf32" for the
    control): the packed saddle-point system solved by restarted flexible
    GMRES to the configuration's tolerance (`solver`: rtol against ||b -
    A x0|| for tol_mode "r0", x0 = (u^n with g on the Dirichlet rows, p^n),
    or against ||b|| for "b"; restart), in increment form from x0, right-
    preconditioned by the block upper-triangular [[diag(F), -D^T], [0, S]]
    with S = D diag(F)^-1_free D^T solved by Jacobi CG to PRECOND_RTOL.
    Returns (u^{n+1}, p^{n+1}, diagnostics, (iterations, whether GMRES
    reached its tolerance before its cap of ten times maxiter))."""
    T = ref.T
    u_n, p_n = T(u_n), T(p_n)
    n = ref.n_u
    mask = ref.mask[:, None]
    F_e = ref.F_elements(nu, dt, u_n)
    b = torch.cat([torch.where(mask, prob.g, ref.mass(u_n) / dt).reshape(-1), torch.zeros_like(p_n)])

    def split(x):
        return x[: 3 * n].reshape(n, 3), x[3 * n:]

    def A(x):
        u, p = split(x)
        ru = torch.where(mask, u, ref.apply_elements(F_e, u) - ref.div_t(p))
        return torch.cat([ru.reshape(-1), ref.div(u)])

    dinv = torch.where(ref.mask, torch.zeros_like(ref.diagM), 1.0 / ref.diag_F(F_e))
    d_s = ref.diag_S1(dinv)

    def S(q):
        return ref.div(dinv[:, None] * ref.div_t(q))

    def P(x):
        ru, rp = split(x)
        tol_s = PRECOND_RTOL * float(torch.linalg.norm(rp))
        zp, _ = cg(S, rp, torch.zeros_like(rp), lambda q: q / d_s, tol_s, PRECOND_MAXITER)
        zu = torch.where(mask, ru, dinv[:, None] * (ru + ref.div_t(zp)))
        return torch.cat([zu.reshape(-1), zp])

    x0 = torch.cat([torch.where(mask, prob.g, u_n).reshape(-1), p_n])
    r0 = b - A(x0)
    tol = solver["rtol"] * float(torch.linalg.norm(r0 if solver["tol_mode"] == "r0" else b))
    cap = 10 * solver["maxiter"]
    dx, its = gmres(A, r0, torch.zeros_like(r0), P, tol, solver["restart"], cap)
    u_new, p_new = split(x0 + dx)
    return u_new, p_new, prob.diagnostics(u_new, p_new, nu), (its, its < cap)


# ----------------------------------------------------------------------
# Which check a configuration takes, and what none covers
# ----------------------------------------------------------------------
class Scheme(NamedTuple):
    numbers: Callable  # (ref, prob, u_n, p_n, u_new, p_new, diag, nu, dt) -> dict
    control: Callable  # (ref, prob, u_n, p_n, nu, dt, solver) -> (u, p, diag, info)


SCHEMES = {
    "projection": Scheme(step_numbers, control_step),
    "monolithic": Scheme(monolithic_numbers, monolithic_control_step),
}


def refuse_uncovered(time_cfg: dict, solver: dict, dimension) -> None:
    """Raise ValueError, naming the setting, for a configuration (its
    `run_config.time` and `.solver`, and its mesh's dimension) that the
    check does not cover."""
    stepper = time_cfg.get("stepper")
    settings = [
        ("time.stepper", stepper, tuple(SCHEMES)),
        ("time.scheme", time_cfg.get("scheme"), ("bdf1",)),
        ("time.convection", time_cfg.get("convection"), ("implicit",)),
        ("dimension", dimension, (3,)),
    ]
    if stepper == "monolithic":  # the control's tolerance modes
        settings.append(("solver.tol_mode", solver.get("tol_mode"), ("r0", "b")))
    for name, value, ok in settings:
        if value not in ok:
            raise ValueError(
                f"the correctness check does not cover {name}={value!r} (it covers {ok}): "
                "nsbench/reference/check.py states no equations for it"
            )
