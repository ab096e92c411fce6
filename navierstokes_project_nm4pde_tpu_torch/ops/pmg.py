"""p-multigrid (P2 -> P1) two-level preconditioner for the velocity block,
for the block preconditioners' f_solver "pmg".

The counterpart of the reference's `ops/pmg.py` (`build_velocity_pmg`,
`pmg_vals`, `pmg_matvec`, `restrict_p`, `prolong_p`, `pmg_coarse_solve`):

    z = omega D^-1 r + P Fc^-1 P^T r

with P the P2-onto-P1 embedding (vertex values pass through, edge-node
values are endpoint means), Fc = M1/dt + nu A1 the assembled P1 scalar
operator (convection dropped; Dirichlet vertex rows and columns
eliminated) held as two [n_v, W] ELL value tables combined per step, and
Fc^-1 a fixed-iteration Jacobi-CG.  P^T is a segmented sum over the
vertex self slots and the two endpoint slots of every edge node.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    SegmentPlan,
    apply_segment_plan,
    build_segment_plan,
)
from navierstokes_project_nm4pde_tpu_torch.solvers.krylov import cg_fixed


@dataclasses.dataclass
class VelocityPMG:
    """Static P2 -> P1 two-level structure (built once per mesh)."""

    cols: torch.Tensor  # [n_v, W] int64 coarse ELL columns (pad: own row)
    m_vals: torch.Tensor  # [n_v, W] P1 mass values (Dirichlet-eliminated)
    a_vals: torch.Tensor  # [n_v, W] P1 stiffness values (Dirichlet-eliminated)
    diag_onehot: torch.Tensor  # [n_v, W] 1.0 exactly at the diagonal slot
    dir_v: torch.Tensor  # [n_v] bool Dirichlet vertex mask
    edges: torch.Tensor  # [n_e, 2] int64 endpoint vertices of each edge node
    plan_r: SegmentPlan  # P^T: n_v + 2 n_e slots -> n_v rows
    n_v: int


def build_velocity_pmg(space, geom, dirichlet_mask, dtype, device) -> VelocityPMG:
    """Host-assemble the P1 coarse operator and the transfer tables.
    `dirichlet_mask` is the fine [n_unodes] mask; its first n_v entries are
    the vertex constraints (the P2 node order puts vertices first)."""
    mesh = space.mesh
    dim = mesh.dim
    cells = np.asarray(mesh.cells, dtype=np.int64)  # [E, dim+1]
    coords = np.asarray(mesh.coords)
    n_v = mesh.n_vertices

    # element matrices
    v = coords[cells]  # [E, dim+1, dim]
    J = np.swapaxes(v[:, 1:] - v[:, :1], 1, 2)  # [E, dim, dim]
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    gref1 = np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)
    g = np.einsum("ik,ekd->eid", gref1, Jinv)  # [E, dim+1, dim]
    A_e = np.einsum("eid,ejd->eij", g, g) * detJ[:, None, None]
    # P1 mass on the reference simplex: detJ (1 + delta_ij) / c
    nl = dim + 1
    Mref = np.ones((nl, nl)) + np.eye(nl)
    Mref *= {2: 1.0 / 24.0, 3: 1.0 / 120.0}[dim]
    M_e = Mref[None] * detJ[:, None, None]

    # Dirichlet elimination (rows and columns)
    dir_v = np.asarray(dirichlet_mask)[:n_v]
    dmask_e = dir_v[cells]  # [E, nl]
    keep = ~(dmask_e[:, :, None] | dmask_e[:, None, :])
    A_e = np.where(keep, A_e, 0.0)
    M_e = np.where(keep, M_e, 0.0)

    # assemble to ELL (sort/unique over (row, col) keys)
    rows = np.repeat(cells, nl, axis=1).reshape(-1)
    colsf = np.tile(cells, (1, nl)).reshape(-1)
    key = rows * np.int64(n_v) + colsf
    order = np.argsort(key, kind="stable")
    uniq, start = np.unique(key[order], return_index=True)
    a_red = np.add.reduceat(A_e.reshape(-1)[order], start)
    m_red = np.add.reduceat(M_e.reshape(-1)[order], start)
    urow = (uniq // n_v).astype(np.int64)
    ucol = (uniq % n_v).astype(np.int64)
    # drop eliminated zero couplings (keep diagonals so every row exists)
    keep_nz = (np.abs(a_red) + np.abs(m_red) > 0) | (urow == ucol)
    urow, ucol = urow[keep_nz], ucol[keep_nz]
    a_red, m_red = a_red[keep_nz], m_red[keep_nz]
    counts = np.bincount(urow, minlength=n_v)
    W = int(counts.max())
    slot = np.arange(len(urow)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[urow]
    cols = np.tile(np.arange(n_v, dtype=np.int64)[:, None], (1, W))
    a_tab = np.zeros((n_v, W))
    m_tab = np.zeros((n_v, W))
    donehot = np.zeros((n_v, W))
    cols[urow, slot] = ucol
    a_tab[urow, slot] = a_red
    m_tab[urow, slot] = m_red
    dsel = urow == ucol
    donehot[urow[dsel], slot[dsel]] = 1.0

    # P^T plan: slots = [vertex self | edge end 0 | edge end 1]
    edges = np.asarray(space.edges, dtype=np.int64)
    slots = np.concatenate([np.arange(n_v), edges[:, 0], edges[:, 1]])
    val = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    return VelocityPMG(
        cols=torch.as_tensor(cols, device=device),
        m_vals=val(m_tab),
        a_vals=val(a_tab),
        diag_onehot=val(donehot),
        dir_v=torch.as_tensor(dir_v, device=device),
        edges=torch.as_tensor(edges, device=device),
        plan_r=build_segment_plan(slots, n_v, device=device),
        n_v=n_v,
    )


def pmg_vals(pmg: VelocityPMG, nu, dt):
    """Per-step coarse ELL values Fc = M1/dt + nu A1 (identity Dirichlet
    rows) and the inverse diagonal: [n_v, W] and [n_v], or one set a member
    ([n_v, W, B], [n_v, B]) for a [B] tensor nu."""
    if torch.is_tensor(nu) and nu.dim() == 1:
        vals = pmg.m_vals[..., None] / dt + nu * pmg.a_vals[..., None]
        onehot = pmg.diag_onehot[..., None]
        vals = torch.where(pmg.dir_v[:, None, None], onehot, vals)
        return vals, 1.0 / torch.sum(onehot * vals, dim=1)
    vals = pmg.m_vals / dt + nu * pmg.a_vals
    vals = torch.where(pmg.dir_v[:, None], pmg.diag_onehot, vals)
    diag = torch.sum(pmg.diag_onehot * vals, dim=1)
    return vals, 1.0 / diag


def pmg_matvec(pmg: VelocityPMG, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Coarse SpMV, payload [n_v, d] (or [n_v, d, B] with one value set a
    member)."""
    if vals.dim() == 3:
        return torch.einsum("vwb,vwdb->vdb", vals, x[pmg.cols])
    return torch.einsum("vw,vwd->vd", vals, x[pmg.cols])


def restrict_p(pmg: VelocityPMG, r: torch.Tensor) -> torch.Tensor:
    """P^T r: [n_unodes, d, *rest] -> [n_v, d, *rest] (edge residuals
    split to endpoints)."""
    n_v = pmg.n_v
    flat = torch.cat([r[:n_v], 0.5 * r[n_v:], 0.5 * r[n_v:]], dim=0)
    rc = apply_segment_plan(pmg.plan_r, flat.reshape(flat.shape[0], -1)).view(n_v, *r.shape[1:])
    dir_v = pmg.dir_v.view(-1, *(1,) * (r.dim() - 1))
    return torch.where(dir_v, torch.zeros_like(rc), rc)


def prolong_p(pmg: VelocityPMG, zc: torch.Tensor, n_unodes: int) -> torch.Tensor:
    """P zc: [n_v, d] -> [n_unodes, d] (edge values = endpoint means)."""
    ze = 0.5 * (zc[pmg.edges[:, 0]] + zc[pmg.edges[:, 1]])
    return torch.cat([zc, ze], dim=0)


def pmg_coarse_solve(pmg, vals, inv_diag, rc, iters: int, precise=False):
    """Fixed-iteration Jacobi-CG on the coarse operator, payload [n_v, d]
    (or [n_v, d, B], one CG a member)."""
    shape = rc.shape
    flat = (shape[0] * shape[1], *shape[2:])

    def A(v):
        return pmg_matvec(pmg, vals, v.reshape(shape)).reshape(flat)

    def M(v):
        return (inv_diag.unsqueeze(1) * v.reshape(shape)).reshape(flat)

    return cg_fixed(A, rc.reshape(flat), M, iters=iters, precise=precise).reshape(shape)
