"""Matrix-free velocity operator F = M/dt + nu A + C(w) and the static
per-mesh operator data (PyTorch).

The counterpart of the reference's `ops/operators.py`, restricted to what
the projection stepper's macro path reads: the host side of
`build_operator` (geometry factors, reference tables, global diagonals,
the divergence ELL and the frozen Schur host tables), `gather_u`,
`convection_setup` with the fold, and `apply_F` as the element reference.
D and G are the assembled forms of `ops/bsr.py`.

Layout: velocity `u[n_unodes, dim]`, pressure `p[n_pnodes]`; every array
lives on the device passed to `build_operator`.
"""

from __future__ import annotations

import dataclasses

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
    plan_u: SegmentPlan  # [E * n_loc_u] element slots -> [n_unodes]
    detJ: torch.Tensor  # [E]
    Jinv: torch.Tensor  # [E, dim, dim]
    GKd: torch.Tensor  # [E, dim, dim] = detJ * Jinv @ Jinv^T
    W: torch.Tensor  # [q] quadrature weights
    PHI_U: torch.Tensor  # [q, nloc]
    GRAD_U: torch.Tensor  # [q, nloc, dim]
    MHAT: torch.Tensor  # [nloc, nloc]
    AHAT: torch.Tensor  # [dim, dim, nloc, nloc]
    diagM: torch.Tensor  # [n_unodes] mass diagonal (unscaled by dt)
    diagA: torch.Tensor  # [n_unodes] stiffness diagonal (unscaled by nu)
    dirichlet_mask: torch.Tensor  # [n_unodes] bool
    div: CSRMatrix  # D: [n_unodes, dim] -> [n_pnodes, 1]
    grad: CSRMatrix  # G = -D^T: [n_pnodes, 1] -> [n_unodes, dim]
    coarse: CoarseSchur


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
        plan_u=build_segment_plan(space.cells_u, space.n_unodes, device=device),
        detJ=dev(geom.detJ),
        Jinv=dev(geom.Jinv),
        GKd=dev(GKd),
        W=dev(t.W),
        PHI_U=dev(t.PHI_U),
        GRAD_U=dev(t.GRAD_U),
        MHAT=dev(t.MHAT),
        AHAT=dev(t.AHAT),
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
    """[n_unodes, C] -> [E, n_loc_u, C] element view."""
    return u[op.cells_u]


def scatter_u(op: NSOperator, y_e: torch.Tensor) -> torch.Tensor:
    """[E, n_loc_u, C] element contributions -> [n_unodes, C]."""
    return apply_segment_plan(op.plan_u, y_e.reshape(-1, y_e.shape[-1]))


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


@dataclasses.dataclass
class ConvectionData:
    WG: torch.Tensor  # [E, q, nloc] (w . grad phi_i)(x_q)
    divw: torch.Tensor  # [E, q] div w (x_q)
    diagC: torch.Tensor | None  # global diag of C(w); None with with_diag=False
    # Folded per-element F_e = detJ/dt M^ + nu GKd:A^ + C_e(w) [E, nloc, nloc]
    # for the (nu, dt) in `fold`.
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

    `w_e` is a pre-gathered element view of w; `base_e` the setup-time
    `conv_base(op)`; `with_diag=False` skips diag(C) (the stepper's
    freeze_conv_diag mode)."""
    if w_e is None:
        w_e = gather_u(op, w)
    w_q = torch.einsum("qi,eic->eqc", op.PHI_U, w_e)
    wtilde = torch.einsum("ekd,eqd->eqk", op.Jinv, w_q)
    WG = torch.einsum("qik,eqk->eqi", op.GRAD_U, wtilde)
    gref = torch.einsum("qik,eic->eqkc", op.GRAD_U, w_e)
    divw = torch.einsum("eqkc,ekc->eq", gref, op.Jinv)
    diagC = None
    if with_diag:
        # sum_q jxw (WG_i phi_i + 0.5 divw phi_i^2)
        d_e = torch.einsum(
            "q,eqi,qi->ei", op.W, WG + 0.5 * divw[:, :, None] * op.PHI_U[None],
            op.PHI_U,
        ) * op.detJ[:, None]
        diagC = scatter_u(op, d_e[:, :, None])[:, 0]
    F_e = None
    if fold is not None:
        nu, dt = fold
        F_e = op.MHAT[None] * (op.detJ / dt)[:, None, None]
        F_e = F_e + nu * (conv_base(op) if base_e is None else base_e)
        R = WG + 0.5 * divw[:, :, None] * op.PHI_U[None]
        WPHI = op.W[:, None] * op.PHI_U  # [q, i]
        F_e = F_e + torch.einsum("qi,eqj->eij", WPHI, R) * op.detJ[:, None, None]
    return ConvectionData(WG=WG, divw=divw, diagC=diagC, F_e=F_e, fold=fold)


def apply_F(op: NSOperator, nu, dt, conv: ConvectionData, u: torch.Tensor) -> torch.Tensor:
    """F u through the folded element matrices (the element reference the
    macro path is tested against)."""
    if conv.F_e is None or conv.fold is None:
        raise ValueError("apply_F needs a folded ConvectionData")
    fnu, fdt = conv.fold
    if abs(float(nu) - fnu) > 1e-12 * max(1.0, abs(fnu)) or abs(
        float(dt) - fdt
    ) > 1e-12 * max(1.0, abs(fdt)):
        raise ValueError(
            f"folded ConvectionData was built for (nu={fnu}, dt={fdt}) but "
            f"applied with (nu={nu}, dt={dt})"
        )
    y_e = torch.einsum("eij,ejc->eic", conv.F_e, gather_u(op, u))
    return scatter_u(op, y_e)


def diag_F(op: NSOperator, nu, dt, conv: ConvectionData | None) -> torch.Tensor:
    d = op.diagM / dt + nu * op.diagA
    if conv is not None and conv.diagC is not None:
        d = d + conv.diagC
    return d
