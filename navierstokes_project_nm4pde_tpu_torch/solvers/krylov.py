"""Krylov solvers in PyTorch: flexible GMRES and recycled-projection CG.

The counterparts of the reference's `solvers/krylov.py` `_norm`, `fgmres`
and `cg_recycled`, with the same algorithms and stopping rules, so that a
float64 run takes the same iteration counts as the reference.

The reference runs its loops under `lax.while_loop` on the device.  Here
the loops run in Python and read the residual norm back to the host once
per iteration (one device synchronisation each), which also keeps the
small Hessenberg/Givens algebra of FGMRES on the host in float64.
Removing those synchronisations (checking every k iterations, or CUDA
graphs) is later work.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class SolveInfo(NamedTuple):
    iters: int  # total iterations performed
    residual: float  # final residual norm


def _dot(x, y, precise: bool):
    if precise and x.dtype != torch.float64:
        return torch.dot(x.double(), y.double()).to(x.dtype)
    return torch.dot(x, y)


def _norm(x, precise: bool):
    return torch.sqrt(_dot(x, x, precise))


def _matvec_dots(V, w, precise: bool):
    """Row-wise dot products V @ w as one matmul (optionally f64)."""
    if precise and V.dtype != torch.float64:
        return (V.double() @ w.double()).to(w.dtype)
    return V @ w


def _dot2(x, y, precise: bool):
    """(x.y, y.y) in one reduction."""
    xs = _matvec_dots(torch.stack([x, y]), y, precise)
    return xs[0], xs[1]


# ----------------------------------------------------------------------
# Flexible GMRES
# ----------------------------------------------------------------------
def fgmres(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-6,
    atol: float = 0.0,
    restart: int = 50,
    maxiter: int = 200,
    precise: bool = True,
    tol_mode: str = "r0",
):
    """Solve A x = b by right-preconditioned flexible GMRES (CGS2
    orthogonalisation, Givens rotations, restarts).  Returns (x, SolveInfo).

    tol_mode: "r0" (rtol relative to ||b - A x0||), "b" (to ||b||) or
    "abs" (absolute).  A zero guess (x0=None) skips the A(x0) apply."""
    if M is None:
        M = lambda v: v  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
        r_init = b
    else:
        r_init = b - A(x0)
    r0_norm = float(_norm(r_init, precise))
    if tol_mode == "r0":
        ref_norm = r0_norm
    elif tol_mode == "b":
        ref_norm = float(_norm(b, precise))
    elif tol_mode == "abs":
        ref_norm = 1.0
    else:
        raise ValueError(f"unknown tol_mode: {tol_mode}")
    tol = max(rtol * ref_norm, float(atol))

    x, r, res, iters = x0, r_init, r0_norm, 0
    while res > tol and iters < maxiter:
        x, r, res, j = _fgmres_cycle(A, M, x, r, restart, tol, precise)
        iters += j
    return x, SolveInfo(iters=iters, residual=res)


def _fgmres_cycle(A, M, x, r, m: int, tol: float, precise: bool):
    """One restart cycle from residual `r`: (x, next residual, residual
    norm, iterations).  The next residual comes from the Arnoldi
    recurrence (r_new = g[j] V^T Q^T e_j), not from another apply."""
    n = r.shape[0]
    beta = float(_norm(r, precise))
    V = r.new_zeros((m + 1, n))
    Z = r.new_zeros((m, n))
    H = np.zeros((m + 1, m))
    cs = np.zeros(m)
    sn = np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = beta
    V[0] = r / beta if beta > 0 else r

    j, res = 0, beta
    while j < m and res > tol:
        z = M(V[j])
        w = A(z)
        Vj = V[: j + 1]
        # classical Gram-Schmidt with one reorthogonalisation pass (CGS2)
        h1 = _matvec_dots(Vj, w, precise)
        w = w - h1 @ Vj
        h2 = _matvec_dots(Vj, w, precise)
        w = w - h2 @ Vj
        hlast_t = _norm(w, precise)
        hcol = torch.cat([h1 + h2, hlast_t[None]]).tolist()  # the sync
        hlast = hcol[j + 1]
        V[j + 1] = w / hlast_t if hlast > 0 else w
        Z[j] = z

        for i in range(j):  # accumulated Givens rotations
            t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
            hcol[i], hcol[i + 1] = t1, t2
        denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        c = hcol[j] / denom if denom > 0 else 1.0
        s = hcol[j + 1] / denom if denom > 0 else 0.0
        cs[j], sn[j] = c, s
        hcol[j], hcol[j + 1] = denom, 0.0
        H[: j + 2, j] = hcol
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        res = abs(g[j + 1])
        j += 1

    if j > 0:
        import scipy.linalg

        y = scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
        x = x + torch.as_tensor(y, dtype=r.dtype, device=r.device) @ Z[:j]
    wv = np.zeros(m + 1)
    wv[j] = 1.0
    for i in range(j - 1, -1, -1):  # Q^T e_j: apply G_i^T in reverse
        wi = cs[i] * wv[i] - sn[i] * wv[i + 1]
        wi1 = sn[i] * wv[i] + cs[i] * wv[i + 1]
        wv[i], wv[i + 1] = wi, wi1
    coef = torch.as_tensor(g[j] * wv[: j + 1], dtype=r.dtype, device=r.device)
    r_new = coef @ V[: j + 1]
    return x, r_new, res, j


# ----------------------------------------------------------------------
# CG with a recycled projection space (frozen operators only)
# ----------------------------------------------------------------------
def cg_recycled(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None,
    x0: torch.Tensor | None,
    poolD: torch.Tensor,
    poolW: torch.Tensor,
    *,
    rtol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    precise: bool = True,
):
    """Preconditioned CG warm-started by a least-squares projection onto
    recycled directions `poolD` [k, n] whose exact images `poolW = A poolD`
    are carried along (valid only for an operator frozen across calls).
    Zero pool rows are ignored.  Returns (x, SolveInfo, harvest) with
    harvest = [x - x_proj, r_proj - r_final] ([2, n]): the next pool row
    (direction, image) of this call's CG increment."""
    if M is None:
        M = lambda v: v  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
        r = b
    else:
        r = b - A(x0)
    k = poolD.shape[0]
    dtype = b.dtype

    S = torch.cat([poolW, r[None, :]], dim=0)
    G = _matvec_dots(S, S.T, precise)  # [k+1, k+1]
    wn = torch.sqrt(torch.clamp(torch.diagonal(G)[:k], min=0.0))
    sc = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
    eye = torch.eye(k, dtype=dtype, device=b.device)
    Gn = G[:k, :k] * sc[:, None] * sc[None, :] + 1e-5 * eye
    Gn = torch.where((eye > 0) & (wn == 0)[:, None], torch.ones_like(Gn), Gn)
    h = G[:k, k] * sc
    c = torch.linalg.solve_ex(Gn, h).result
    Dn = poolD * sc[:, None]
    Wn = poolW * sc[:, None]
    x = x0 + c @ Dn
    r = r - c @ Wn
    c2 = torch.linalg.solve_ex(Gn, _matvec_dots(Wn, r, precise)).result
    x = x + c2 @ Dn
    r = r - c2 @ Wn
    x_proj, r_proj = x, r

    z = M(r)
    p = z
    rz, rr = _dot2(z, r, precise)
    res = float(torch.sqrt(rr))
    tol = max(rtol * float(_norm(b, precise)), float(atol))
    j = 0
    while res > tol and j < maxiter:
        Ap = A(p)
        alpha = rz / _dot(p, Ap, precise)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rr = _dot2(z, r, precise)
        p = z + (rz_new / rz) * p
        rz = rz_new
        res = float(torch.sqrt(rr))  # the sync
        j += 1
    harvest = torch.stack([x - x_proj, r_proj - r])
    return x, SolveInfo(iters=j, residual=res), harvest
