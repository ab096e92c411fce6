"""Krylov solvers in PyTorch: flexible GMRES, CG and recycled-projection CG.

The counterparts of the reference's `solvers/krylov.py` `_norm`, `fgmres`,
`cg` and `cg_recycled`, with the same algorithms and stopping rules, so
that a float64 run takes the same iteration counts as the reference.

The reference runs its loops under `lax.while_loop` on the device.  Here
the loops run in Python and read the residual norm back to the host once
per iteration (one device synchronisation each), which also keeps the
small Hessenberg/Givens algebra of FGMRES on the host in float64.
Removing those synchronisations (checking every k iterations, or CUDA
graphs) is later work.

`fgmres` and `cg` also solve [n, B] batches, one column per ensemble
member, with the semantics of `jax.vmap` over the reference's
`lax.while_loop`: each member iterates exactly as its own solve would,
with its own tolerance and iteration count, and a member that has
stopped is frozen while the others run on.  In FGMRES the members still
iterating share the inner index j, so their restart cycles run in
lockstep.  One host sync per iteration reads all B residuals; a single
system is the batch B = 1.
"""

from __future__ import annotations

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


# Column-wise forms for [n, B] batches (one column per member).
def _cdot(x, y, precise: bool):
    """[B] column dot products."""
    if precise and x.dtype != torch.float64:
        return (x.double() * y.double()).sum(0).to(x.dtype)
    return (x * y).sum(0)


def _cnorm(x, precise: bool):
    return torch.sqrt(_cdot(x, x, precise))


def _bdots(V, w, precise: bool):
    """[B, k] dot products of each member's basis rows V [B, k, n] with its
    vector w [B, n] (one batched matmul)."""
    if precise and V.dtype != torch.float64:
        return torch.bmm(V.double(), w.double()[:, :, None])[:, :, 0].to(w.dtype)
    return torch.bmm(V, w[:, :, None])[:, :, 0]


def _bcomb(c, V):
    """[B, n] combinations sum_k c[b, k] V[b, k, :] of basis rows."""
    return torch.bmm(c[:, None, :], V)[:, 0]


def _host(t: torch.Tensor) -> np.ndarray:
    """A small tensor as float64 numpy (the host sync)."""
    return t.detach().to("cpu", torch.float64).numpy()


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
    atol=0.0,
    restart: int = 50,
    maxiter: int = 200,
    precise: bool = True,
    tol_mode: str = "r0",
):
    """Solve A x = b by right-preconditioned flexible GMRES (CGS2
    orthogonalisation, Givens rotations, restarts).  Returns (x, SolveInfo).

    b is one system [n] or B systems [n, B] (A and M then map [n, B] ->
    [n, B] column by column, `atol` is a float or a [B] array, and
    SolveInfo holds [B] numpy iterations and residuals).
    tol_mode: "r0" (rtol relative to ||b - A x0||), "b" (to ||b||) or
    "abs" (absolute).  A zero guess (x0=None) skips the A(x0) apply."""
    if M is None:
        M = lambda v: v  # noqa: E731
    if b.dim() == 1:
        x, info = fgmres(
            lambda v: A(v[:, 0])[:, None], b[:, None], lambda v: M(v[:, 0])[:, None],
            None if x0 is None else x0[:, None], rtol=rtol, atol=atol,
            restart=restart, maxiter=maxiter, precise=precise, tol_mode=tol_mode,
        )
        return x[:, 0], SolveInfo(iters=int(info.iters[0]), residual=float(info.residual[0]))
    n, B = b.shape
    m = restart
    r = b if x0 is None else b - A(x0)
    res = _host(_cnorm(r, precise))
    if tol_mode == "r0":
        ref = res
    elif tol_mode == "b":
        ref = _host(_cnorm(b, precise))
    elif tol_mode == "abs":
        ref = np.ones(B)
    else:
        raise ValueError(f"unknown tol_mode: {tol_mode}")
    tol = np.maximum(rtol * ref, np.broadcast_to(np.asarray(atol, np.float64), (B,)))

    # Inside, vectors are member-major rows [B, n], so that each member's
    # basis is one contiguous [k, n] block and the Gram-Schmidt products
    # are batched matmuls (A and M still see [n, B] columns).
    r = r.T.contiguous()
    x = torch.zeros_like(r) if x0 is None else x0.T.contiguous()
    iters = np.zeros(B, np.int64)
    active = (res > tol) & (iters < maxiter)
    while active.any():
        beta_t = _cnorm(r.T, precise)
        beta = _host(beta_t)
        V = r.new_zeros((B, m + 1, n))
        Z = r.new_zeros((B, m, n))
        H = np.zeros((B, m + 1, m))
        cs = np.zeros((B, m))
        sn = np.zeros((B, m))
        g = np.zeros((B, m + 1))
        g[:, 0] = beta
        V[:, 0] = torch.where(beta_t[:, None] > 0, r / beta_t[:, None], r)
        jm = np.zeros(B, np.int64)  # each member's inner iterations this cycle
        res_c = beta.copy()
        j = 0
        while j < m:
            live = active & (res_c > tol)
            if not live.any():
                break
            z = M(V[:, j].T)
            w = A(z).T.contiguous()
            Vj = V[:, : j + 1]
            h1 = _bdots(Vj, w, precise)
            w = w - _bcomb(h1, Vj)
            h2 = _bdots(Vj, w, precise)
            w = w - _bcomb(h2, Vj)
            hlast_t = _cnorm(w.T, precise)
            hcol = _host(torch.cat([h1 + h2, hlast_t[:, None]], dim=1)).T  # the sync, [j+2, B]
            V[:, j + 1] = torch.where(hlast_t[:, None] > 0, w / hlast_t[:, None], w)
            Z[:, j] = z.T

            for i in range(j):  # accumulated Givens rotations, all members
                t1 = cs[:, i] * hcol[i] + sn[:, i] * hcol[i + 1]
                t2 = -sn[:, i] * hcol[i] + cs[:, i] * hcol[i + 1]
                hcol[i], hcol[i + 1] = t1, t2
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            safe = np.where(denom > 0, denom, 1.0)
            c = np.where(denom > 0, hcol[j] / safe, 1.0)
            s_ = np.where(denom > 0, hcol[j + 1] / safe, 0.0)
            hcol[j], hcol[j + 1] = denom, 0.0
            # only the members still iterating take this column
            cs[live, j], sn[live, j] = c[live], s_[live]
            H[live, : j + 2, j] = hcol.T[live]
            gj = g[:, j].copy()
            g[live, j + 1] = -s_[live] * gj[live]
            g[live, j] = c[live] * gj[live]
            res_c = np.where(live, np.abs(g[:, j + 1]), res_c)
            jm += live
            j += 1

        # per member, as the reference masks it: y = H[:jm, :jm]^-1 g[:jm]
        # by back substitution (an identity block past jm), x += Z^T y, and
        # the next residual from the recurrence, r = g[jm] V^T Q^T e_jm
        act = np.arange(m)[None, :] < jm[:, None]  # [B, m]
        Hm = np.where(act[:, :, None] & act[:, None, :], H[:, :m, :m], 0.0)
        Hm[:, np.arange(m), np.arange(m)] += np.where(act, 0.0, 1.0)
        gm = np.where(act, g[:, :m], 0.0)
        Y = np.zeros((B, m))
        for i in range(m - 1, -1, -1):
            Y[:, i] = (gm[:, i] - (Hm[:, i, i + 1:] * Y[:, i + 1:]).sum(1)) / Hm[:, i, i]
        rows = np.arange(B)
        wv = np.zeros((B, m + 1))
        wv[rows, jm] = 1.0
        for i in range(m - 1, -1, -1):  # Q^T e_jm: apply G_i^T in reverse, i < jm
            wi = cs[:, i] * wv[:, i] - sn[:, i] * wv[:, i + 1]
            wi1 = sn[:, i] * wv[:, i] + cs[:, i] * wv[:, i + 1]
            sel = i < jm
            wv[:, i] = np.where(sel, wi, wv[:, i])
            wv[:, i + 1] = np.where(sel, wi1, wv[:, i + 1])
        Cr = g[rows, jm][:, None] * wv
        on = torch.as_tensor(active, device=b.device)[:, None]
        Yt = torch.as_tensor(Y, dtype=b.dtype, device=b.device)
        Crt = torch.as_tensor(Cr, dtype=b.dtype, device=b.device)
        x = torch.where(on, x + _bcomb(Yt, Z), x)
        r = torch.where(on, _bcomb(Crt, V), r)
        res = np.where(active, res_c, res)
        iters = iters + np.where(active, jm, 0)
        active = (res > tol) & (iters < maxiter)
    x = x.T.contiguous()
    return x, SolveInfo(iters=iters, residual=res)


# ----------------------------------------------------------------------
# CG
# ----------------------------------------------------------------------
def cg(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-6,
    atol=0.0,
    maxiter: int = 1000,
    precise: bool = True,
):
    """Preconditioned CG for B systems at once: b [n, B], A and M map
    [n, B] -> [n, B] column by column; `atol` is a float or a [B] array.
    The residual norm rides the loop (fused with r.z), as in the
    reference.  Returns (x [n, B], SolveInfo with [B] numpy iters and
    residuals).  A single system is the case B = 1."""
    if M is None:
        M = lambda v: v  # noqa: E731
    B = b.shape[1]
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    z = M(r)
    p = z
    rz, rr = _cdot(z, r, precise), _cdot(r, r, precise)
    res = _host(torch.sqrt(rr))
    bnorm = _host(_cnorm(b, precise))
    tol = np.maximum(rtol * bnorm, np.broadcast_to(np.asarray(atol, np.float64), (B,)))
    k = np.zeros(B, np.int64)
    active = (res > tol) & (k < maxiter)
    while active.any():
        on = torch.as_tensor(active, device=b.device)
        Ap = A(p)
        alpha = rz / _cdot(p, Ap, precise)
        x = torch.where(on, x + alpha * p, x)
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new, rr = _cdot(z, r_new, precise), _cdot(r_new, r_new, precise)
        p = torch.where(on, z + (rz_new / rz) * p, p)
        r = torch.where(on, r_new, r)
        rz = torch.where(on, rz_new, rz)
        res = np.where(active, _host(torch.sqrt(rr)), res)  # the sync
        k = k + active
        active = (res > tol) & (k < maxiter)
    return x, SolveInfo(iters=k, residual=res)


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
