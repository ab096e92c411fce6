"""Affine-element geometry: Jacobians and boundary-facet quadrature tables.

The port's copy of the JAX package's `fem/geometry.py` (numpy only).

Replaces deal.II `FEValues`/`FEFaceValues` (Jacobians, JxW, shape
values/gradients, normals; ref: src/NavierStokes2D.cpp:173-181).  Because the
elements are affine simplices, all geometry is constant per cell, so the whole
layer is a one-shot host precompute producing static device arrays:

  * cell geometry: detJ [E], Jinv [E, dim, dim]
  * boundary tables per facet: shape values/physical gradients of the parent
    cell's basis at facet quadrature points, outward unit normals, JxW.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from navierstokes_project_nm4pde_tpu_torch.fem import quadrature as quad
from navierstokes_project_nm4pde_tpu_torch.fem import reference as ref
from navierstokes_project_nm4pde_tpu_torch.fem.space import TaylorHoodSpace


@dataclasses.dataclass
class CellGeometry:
    J: np.ndarray  # [E, dim, dim]   columns are edge vectors v_i - v_0
    Jinv: np.ndarray  # [E, dim, dim]
    detJ: np.ndarray  # [E] (positive -- mesh is orientation-fixed)


def cell_geometry(space: TaylorHoodSpace) -> CellGeometry:
    coords = space.mesh.coords
    v = coords[space.mesh.cells]  # [E, dim+1, dim]
    # x = v0 + J @ xi with J[:, :, k] = v_{k+1} - v_0
    J = np.transpose(v[:, 1:, :] - v[:, :1, :], (0, 2, 1))
    detJ = np.linalg.det(J)
    if np.any(detJ <= 0):
        raise ValueError("negative-volume cell after orientation fix")
    Jinv = np.linalg.inv(J)
    return CellGeometry(J=J, Jinv=Jinv, detJ=detJ)


@dataclasses.dataclass
class BoundaryTables:
    """Per-boundary-facet quadrature data (all [n_bf, ...])."""

    tag: np.ndarray  # [n_bf]
    cell: np.ndarray  # [n_bf] parent cell id
    phi_u: np.ndarray  # [n_bf, nqf, n_loc_u]   P2 values at facet q-points
    grad_u: np.ndarray  # [n_bf, nqf, n_loc_u, dim]  physical gradients
    phi_p: np.ndarray  # [n_bf, nqf, dim+1]     P1 values at facet q-points
    jxw: np.ndarray  # [n_bf, nqf]
    normal: np.ndarray  # [n_bf, dim]  outward unit normal (constant per facet)
    points: np.ndarray  # [n_bf, nqf, dim]  physical quadrature points


def boundary_tables(
    space: TaylorHoodSpace, geom: CellGeometry, degree: int = 4
) -> BoundaryTables:
    mesh = space.mesh
    dim = mesh.dim
    coords = mesh.coords
    fq_pts, fq_w = quad.face_rule(dim, degree)  # facet reference rule
    nqf = fq_pts.shape[0]
    n_bf = mesh.n_bfaces

    fv = space.bface_pnodes  # [n_bf, dim] facet vertex ids (sorted)
    p = coords[fv]  # [n_bf, dim, dim] facet vertex coords

    # Physical facet quadrature points: affine facet map.
    # facet reference coords s in R^{dim-1}; x = p0 + sum_k s_k (p_{k+1}-p0)
    e = p[:, 1:, :] - p[:, :1, :]  # [n_bf, dim-1, dim]
    pts = p[:, None, 0, :] + np.einsum("qk,fkd->fqd", fq_pts, e)

    # Facet measure scaling and normals.
    if dim == 2:
        t = e[:, 0, :]  # edge vector
        meas = np.linalg.norm(t, axis=1)  # |edge|; ref weights sum to 1
        normal = np.stack([t[:, 1], -t[:, 0]], axis=1) / meas[:, None]
        scale = meas  # total jxw = meas * sum(w) = meas
    else:
        cr = np.cross(e[:, 0, :], e[:, 1, :])
        nrm = np.linalg.norm(cr, axis=1)
        normal = cr / nrm[:, None]
        scale = nrm  # ref weights sum to 1/2 -> total = area = nrm/2
    jxw = scale[:, None] * fq_w[None, :]

    # Fix normal sign: outward = away from the opposite vertex of the parent.
    opp_vert = mesh.cells[space.bface_cell, space.bface_local]
    to_face = p.mean(axis=1) - coords[opp_vert]
    sign = np.sign(np.einsum("fd,fd->f", normal, to_face))
    if np.any(sign == 0):
        raise ValueError("degenerate boundary facet")
    normal = normal * sign[:, None]

    # Parent-cell reference coords of the facet quadrature points.
    v0 = coords[mesh.cells[space.bface_cell, 0]]  # parent cell origin vertex
    Jinv = geom.Jinv[space.bface_cell]  # [n_bf, dim, dim]
    xi = np.einsum("fij,fqj->fqi", Jinv, pts - v0[:, None, :])

    xi_flat = xi.reshape(-1, dim)
    phi_u = ref.p2_shape(xi_flat, dim).reshape(n_bf, nqf, -1)
    gref = ref.p2_grad(xi_flat, dim).reshape(n_bf, nqf, -1, dim)
    # physical gradient: grad_d = sum_k ghat_k * Jinv[k, d]
    grad_u = np.einsum("fqik,fkd->fqid", gref, Jinv)
    phi_p = ref.p1_shape(xi_flat, dim).reshape(n_bf, nqf, -1)

    return BoundaryTables(
        tag=mesh.bface_tag.copy(),
        cell=space.bface_cell.copy(),
        phi_u=phi_u,
        grad_u=grad_u,
        phi_p=phi_p,
        jxw=jxw,
        normal=normal,
        points=pts,
    )
