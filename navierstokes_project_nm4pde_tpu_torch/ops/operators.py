"""Matrix-free velocity operator F = M/dt + nu A + C(w) and the static
per-mesh operator data (PyTorch).

The counterpart of the reference's `ops/operators.py`, restricted to what
the projection stepper reads: the host side of `build_operator` (geometry
factors, reference tables, global diagonals, the divergence ELL and the
frozen Schur host tables), the element gathers and reductions,
`convection_setup` with the fold, and the element passes of the
ensemble step (`apply_rhs_and_r0`, `apply_F`, `apply_divergence_e`,
`apply_gradient_e`).  The single run's D and G are the assembled forms of
`ops/bsr.py`.

Layout: velocity `u[n_unodes, dim]`, pressure `p[n_pnodes]`; every array
lives on the device passed to `build_operator`.  An ensemble carries its
B members on a trailing axis (`u[n_unodes, dim, B]`, `p[n_pnodes, B]`,
nu a [B] tensor): the element passes take any trailing axes and move
them as packed channels (C = dim * B, component-major) through the slot
gather and reduce of `ops/onehot.py` (kernels D and C on the card).  The
per-member element matrices are then held as F_e[j, e, i, b] = F_e^(b)[e, i, j]
([nloc, E, nloc, B], see `element_apply`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.ops.bsr import (
    CSRMatrix,
    apply_csr,
    build_divergence_csr,
    build_gradient_csr,
)
from navierstokes_project_nm4pde_tpu_torch.ops.coarse import (
    CoarseSchur,
    build_coarse_schur,
)
from navierstokes_project_nm4pde_tpu_torch.ops.onehot import (
    OneHotPlans,
    build_onehot_plans,
    onehot_gather,
    onehot_reduce,
)
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    SegmentPlan,
    apply_segment_plan,
    build_segment_plan,
)
from navierstokes_project_nm4pde_tpu_torch.ops.schur_ell import build_schur_frozen
from navierstokes_project_nm4pde_tpu_torch.ops.tables import build_ref_tables


@dataclasses.dataclass
class NSOperator:
    """Static per-mesh operator data (tensors on one device)."""

    cells_u: torch.Tensor  # [E, n_loc_u] int64
    cells_p: torch.Tensor  # [E, dim + 1] int64
    plan_p: SegmentPlan  # [E * (dim + 1)] pressure element slots -> [n_pnodes]
    detJ: torch.Tensor  # [E]
    Jinv: torch.Tensor  # [E, dim, dim]
    GKd: torch.Tensor  # [E, dim, dim] = detJ * Jinv @ Jinv^T
    W: torch.Tensor  # [q] quadrature weights
    PHI_U: torch.Tensor  # [q, nloc]
    GRAD_U: torch.Tensor  # [q, nloc, dim]
    MHAT: torch.Tensor  # [nloc, nloc]
    AHAT: torch.Tensor  # [dim, dim, nloc, nloc]
    BHAT: torch.Tensor  # [dim, nloc_p, nloc] reference divergence table
    diagM: torch.Tensor  # [n_unodes] mass diagonal (unscaled by dt)
    diagA: torch.Tensor  # [n_unodes] stiffness diagonal (unscaled by nu)
    dirichlet_mask: torch.Tensor  # [n_unodes] bool
    div: CSRMatrix  # D: [n_unodes, dim] -> [n_pnodes, 1]
    grad: CSRMatrix  # G = -D^T: [n_pnodes, 1] -> [n_unodes, dim]
    coarse: CoarseSchur

    @functools.cached_property
    def onehot(self) -> OneHotPlans:
        """Velocity element slots <-> [n_unodes] rows, built at first use:
        only the element passes read them (the ensemble step; in a single
        run, only an unfrozen convection diagonal)."""
        return build_onehot_plans(
            self.cells_u.cpu().numpy(), self.diagM.shape[0], device=self.cells_u.device
        )


def build_operator(
    space, geom, dirichlet_mask: np.ndarray, dtype, device, coarse_agg: int = 24
):
    """Build the operator and the host Schur dict for the frozen projection
    Schur (float64 numpy; `vals1`, slot layout, `diagM`, `D_cols`,
    `D_vals`).  Returns (op, schur_host)."""
    t = build_ref_tables(space.dim)
    GK = np.einsum("ekd,eld->ekl", geom.Jinv, geom.Jinv)
    GKd = GK * geom.detJ[:, None, None]

    diagM = np.zeros(space.n_unodes)
    diagA = np.zeros(space.n_unodes)
    mdiag_e = geom.detJ[:, None] * np.diag(t.MHAT)[None, :]
    adiag_e = np.einsum("ekl,kli->ei", GKd, np.einsum("klii->kli", t.AHAT))
    np.add.at(diagM, space.cells_u, mdiag_e)
    np.add.at(diagA, space.cells_u, adiag_e)

    mask = np.asarray(dirichlet_mask, dtype=bool)
    D_cols, D_vals = _assemble_divergence_ell(space, geom, t)
    inv1 = np.where(mask, 0.0, 1.0 / diagM)
    schur_host = build_schur_frozen(D_cols, D_vals, inv1, space.n_unodes)
    schur_host["diagM"] = diagM
    schur_host["D_cols"] = D_cols
    schur_host["D_vals"] = D_vals

    dev = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    idx = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)  # noqa: E731
    op = NSOperator(
        cells_u=idx(space.cells_u),
        cells_p=idx(space.cells_p),
        plan_p=build_segment_plan(space.cells_p, space.n_pnodes, device=device),
        detJ=dev(geom.detJ),
        Jinv=dev(geom.Jinv),
        GKd=dev(GKd),
        W=dev(t.W),
        PHI_U=dev(t.PHI_U),
        GRAD_U=dev(t.GRAD_U),
        MHAT=dev(t.MHAT),
        AHAT=dev(t.AHAT),
        BHAT=dev(t.BHAT),
        diagM=dev(diagM),
        diagA=dev(diagA),
        dirichlet_mask=torch.as_tensor(mask, device=device),
        div=build_divergence_csr(
            schur_host, space.n_unodes, space.n_pnodes, dtype, device
        ),
        grad=build_gradient_csr(
            schur_host, space.n_unodes, space.n_pnodes, dtype, device
        ),
        coarse=build_coarse_schur(space.n_pnodes, agg=coarse_agg),
    )
    return op, schur_host


def _assemble_divergence_ell(space, geom, t):
    """D (pressure rows x velocity-node cols, one value per velocity
    component) as padded ELL: cols [n_p, W], vals [n_p, W, dim]."""
    import scipy.sparse as sp

    dim = space.dim
    n_locp, n_locu = t.PHI_P.shape[1], t.PHI_U.shape[1]
    # D_e[i, j, c] = detJ * sum_k Jinv[k, c] BHAT[k, i, j]
    D_e = np.einsum("ekc,kij->eijc", geom.Jinv, t.BHAT) * geom.detJ[:, None, None, None]
    rows = np.repeat(space.cells_p.astype(np.int64), n_locu, axis=1).reshape(-1)
    cols = np.tile(space.cells_u.astype(np.int64), (1, n_locp)).reshape(-1)
    vals = D_e.reshape(-1, dim)
    csr = [
        sp.csr_matrix(
            (vals[:, d], (rows, cols)), shape=(space.n_pnodes, space.n_unodes)
        )
        for d in range(dim)
    ]
    for c in csr:
        c.sum_duplicates()
        c.sort_indices()
        if c.nnz != csr[0].nnz:
            raise ValueError("divergence components disagree on the pattern")
    indptr, indices = csr[0].indptr, csr[0].indices
    counts = np.diff(indptr)
    Wd = int(counts.max())
    urow = np.repeat(np.arange(space.n_pnodes, dtype=np.int64), counts)
    slot = np.arange(indices.shape[0], dtype=np.int64) - indptr[:-1][urow]
    D_cols = np.zeros((space.n_pnodes, Wd), dtype=np.int64)
    D_vals = np.zeros((space.n_pnodes, Wd, dim))
    D_cols[urow, slot] = indices
    for d in range(dim):
        D_vals[urow, slot, d] = csr[d].data
    return D_cols, D_vals


def gather_u(op: NSOperator, u: torch.Tensor) -> torch.Tensor:
    """[n_unodes, *rest] -> [E, n_loc_u, *rest] element view (kernel D on
    the card, the trailing axes packed as channels)."""
    E, nloc = op.cells_u.shape
    y = onehot_gather(op.onehot, u.reshape(u.shape[0], -1).contiguous())
    return y.view(E, nloc, *u.shape[1:])


def scatter_u(op: NSOperator, y_e: torch.Tensor) -> torch.Tensor:
    """[E, n_loc_u, *rest] element contributions -> [n_unodes, *rest]
    (kernel C on the card)."""
    flat = y_e.reshape(op.onehot.n_slots, -1).contiguous()
    return onehot_reduce(op.onehot, flat).view(op.onehot.n_rows, *y_e.shape[2:])


def gather_p(op: NSOperator, p: torch.Tensor) -> torch.Tensor:
    """[n_pnodes, *rest] -> [E, dim + 1, *rest] (a plain gather, as in the
    reference, which computes it outside Pallas)."""
    return p[op.cells_p]


def scatter_p(op: NSOperator, y_e: torch.Tensor) -> torch.Tensor:
    """[E, dim + 1, *rest] -> [n_pnodes, *rest] (plain segmented sum)."""
    flat = y_e.reshape(op.plan_p.n_slots, -1)
    return apply_segment_plan(op.plan_p, flat).view(op.plan_p.n_rows, *y_e.shape[2:])


def conv_base(op: NSOperator) -> torch.Tensor:
    """Constant element stiffness GKd:AHAT [E, nloc, nloc] (computed once
    at setup, like the reference's DeviceData.conv_base)."""
    return torch.einsum("ekl,klij->eij", op.GKd, op.AHAT)


def apply_divergence(op: NSOperator, u: torch.Tensor) -> torch.Tensor:
    """y = D u: [n_unodes, dim] -> [n_pnodes]."""
    return apply_csr(op.div, u)[:, 0]


def apply_gradient(op: NSOperator, p: torch.Tensor) -> torch.Tensor:
    """y = G p = -D^T p: [n_pnodes] -> [n_unodes, dim]."""
    return apply_csr(op.grad, p[:, None])


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with n trailing singleton axes (to broadcast over members)."""
    return x.reshape(x.shape + (1,) * n)


def apply_divergence_e(op: NSOperator, u_e: torch.Tensor) -> torch.Tensor:
    """y = D u from an element view u_e [E, n_loc_u, dim, *rest] ->
    [n_pnodes, *rest] (the reference's element divergence pass)."""
    y_e = torch.einsum("ekc,kij,ejc...->ei...", op.Jinv, op.BHAT, u_e)
    return scatter_p(op, y_e * _tail(op.detJ[:, None], u_e.dim() - 3))


def apply_gradient_e(op: NSOperator, p: torch.Tensor) -> torch.Tensor:
    """y = G p = -D^T p by the element pass: [n_pnodes, *rest] ->
    [n_unodes, dim, *rest] (its reduction is kernel C on the card)."""
    p_e = gather_p(op, p)
    y_e = torch.einsum("ekc,kij,ei...->ejc...", op.Jinv, op.BHAT, p_e)
    return scatter_u(op, -y_e * _tail(op.detJ[:, None, None], p.dim() - 1))


@dataclasses.dataclass
class ConvectionData:
    WG: torch.Tensor  # [E, q, nloc, *rest] (w . grad phi_i)(x_q)
    divw: torch.Tensor  # [E, q, *rest] div w (x_q)
    diagC: torch.Tensor | None  # global diag of C(w); None with with_diag=False
    # Folded per-element F_e = detJ/dt M^ + nu GKd:A^ + C_e(w) for the
    # (nu, dt) in `fold`: [E, nloc, nloc]; for a [B] tensor nu one matrix
    # set per member, held as F_e[j, e, i, b] ([nloc, E, nloc, B]).
    F_e: torch.Tensor | None = None
    fold: tuple | None = None


def convection_setup(
    op: NSOperator,
    w: torch.Tensor,
    fold: tuple | None = None,
    w_e: torch.Tensor | None = None,
    with_diag: bool = True,
    base_e: torch.Tensor | None = None,
) -> ConvectionData:
    """Tabulate the linearised convection + Temam term of C(w) at the
    quadrature points and, with `fold=(nu, dt)`, fold the per-element F_e.

    `w` may carry trailing member axes ([n, dim, B]); nu in `fold` is then
    a [B] tensor.  `w_e` is a pre-gathered element view of w; `base_e` the
    setup-time `conv_base(op)`; `with_diag=False` skips diag(C) (the
    stepper's freeze_conv_diag mode)."""
    if w_e is None:
        w_e = gather_u(op, w)
    tail = w_e.dim() - 3
    w_q = torch.einsum("qi,eic...->eqc...", op.PHI_U, w_e)
    wtilde = torch.einsum("ekd,eqd...->eqk...", op.Jinv, w_q)
    WG = torch.einsum("qik,eqk...->eqi...", op.GRAD_U, wtilde)
    gref = torch.einsum("qik,eic...->eqkc...", op.GRAD_U, w_e)
    divw = torch.einsum("eqkc...,ekc->eq...", gref, op.Jinv)
    R = WG + 0.5 * divw[:, :, None] * _tail(op.PHI_U[None], tail)
    diagC = None
    if with_diag:
        # sum_q jxw (WG_i phi_i + 0.5 divw phi_i^2)
        d_e = torch.einsum("q,eqi...,qi->ei...", op.W, R, op.PHI_U)
        diagC = scatter_u(op, d_e * _tail(op.detJ[:, None], tail))
    F_e = None
    if fold is not None:
        nu, dt = fold
        base = conv_base(op) if base_e is None else base_e
        F_e = op.MHAT[None] * (op.detJ / dt)[:, None, None]
        WPHI = op.W[:, None] * op.PHI_U  # [q, i]
        if torch.is_tensor(nu) and nu.dim() == 1:
            # members: [j, E, i, B], the layout `element_apply` streams
            F_e = F_e.permute(2, 0, 1)[..., None] + base.permute(2, 0, 1)[..., None] * nu
            C_e = torch.einsum("qi,eqjb->jeib", WPHI, R) * op.detJ[None, :, None, None]
            F_e = (F_e + C_e).contiguous()
        else:
            F_e = F_e + nu * base
            F_e = F_e + torch.einsum("qi,eqj->eij", WPHI, R) * op.detJ[:, None, None]
    return ConvectionData(WG=WG, divw=divw, diagC=diagC, F_e=F_e, fold=fold)


def _check_fold(conv: ConvectionData, nu, dt) -> None:
    """Raise unless `conv` was folded for this (nu, dt)."""
    if conv.F_e is None or conv.fold is None:
        raise ValueError("the element apply needs a folded ConvectionData")
    fnu, fdt = conv.fold
    if torch.is_tensor(nu) or torch.is_tensor(fnu):
        same_nu = nu is fnu or (
            torch.is_tensor(nu) and torch.is_tensor(fnu) and torch.equal(nu, fnu)
        )
    else:
        same_nu = abs(float(nu) - fnu) <= 1e-12 * max(1.0, abs(fnu))
    if not same_nu or abs(float(dt) - fdt) > 1e-12 * max(1.0, abs(fdt)):
        raise ValueError(
            f"folded ConvectionData was built for (nu={fnu}, dt={fdt}) but "
            f"applied with (nu={nu}, dt={dt})"
        )


def element_apply(F_e: torch.Tensor, x_e: torch.Tensor) -> torch.Tensor:
    """y[e, i, ...] = sum_j F_e[e, i, j] x_e[e, j, ...].

    With per-member matrices (F_e [j, E, i, B], x_e [E, j, c, B]) the
    product is nloc fused multiply-adds into one [E, i, c, B] accumulator,
    each streaming one contiguous [E, i, B] slab of F_e: no [B, E, i, j, c]
    intermediate and no copy of x_e or y.  (cuBLAS's batched GEMM over the
    612,864 tiny (member, cell) products of the 64-member ensemble took
    3.9 ms an apply on an H100, this form 0.74 ms.)"""
    if F_e.dim() == 3:
        return torch.einsum("eij,ejc...->eic...", F_e, x_e)
    y = F_e[0][:, :, None, :] * x_e[:, 0][:, None, :, :]
    for j in range(1, F_e.shape[0]):
        y.addcmul_(F_e[j][:, :, None, :], x_e[:, j][:, None, :, :])
    return y


def apply_F(op: NSOperator, nu, dt, conv: ConvectionData, u: torch.Tensor) -> torch.Tensor:
    """F u through the folded element matrices: [n, dim, *rest] (the
    ensemble's velocity operator, and the element reference the macro
    path is tested against)."""
    _check_fold(conv, nu, dt)
    return scatter_u(op, element_apply(conv.F_e, gather_u(op, u)))


def apply_rhs_and_r0(
    op: NSOperator, h: torch.Tensor, p: torch.Tensor, nu, dt,
    conv: ConvectionData, u0: torch.Tensor,
    h_e: torch.Tensor | None = None, u0_e: torch.Tensor | None = None,
):
    """(b, r0) = (M h - G p,  b - F u0) in one element pass and one
    dual-channel reduction (the reference's einsum branch, folded F_e).
    `h_e`/`u0_e` are pre-gathered element views of h/u0."""
    _check_fold(conv, nu, dt)
    h_e = gather_u(op, h) if h_e is None else h_e
    u0_e = gather_u(op, u0) if u0_e is None else u0_e
    p_e = gather_p(op, p)
    det = _tail(op.detJ[:, None, None], h_e.dim() - 3)
    b_e = torch.einsum("ij,ejc...->eic...", op.MHAT, h_e) * det
    b_e = b_e + torch.einsum("ekc,kij,ei...->ejc...", op.Jinv, op.BHAT, p_e) * det
    f_e = element_apply(conv.F_e, u0_e)
    y = scatter_u(op, torch.cat([b_e, b_e - f_e], dim=2))
    d = h.shape[1]
    return y[:, :d], y[:, d:]


def diag_F(op: NSOperator, nu, dt, conv: ConvectionData | None) -> torch.Tensor:
    """diag(F): [n_unodes], or [n_unodes, B] for a [B] tensor nu."""
    if torch.is_tensor(nu) and nu.dim() == 1:
        d = op.diagM[:, None] / dt + nu * op.diagA[:, None]
    else:
        d = op.diagM / dt + nu * op.diagA
    if conv is not None and conv.diagC is not None:
        d = d + conv.diagC
    return d
