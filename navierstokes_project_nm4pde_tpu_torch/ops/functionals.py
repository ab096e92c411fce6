"""Benchmark functionals: drag/lift on the obstacle, pressure probes and
the error norms of a manufactured solution.

The counterpart of the reference's `ops/functionals.py` (`build_force_tables`,
`forces_2d`, `forces_3d`, `drag_lift_coefficients`, `build_point_probe`,
`ErrorTables`, `build_error_tables`, `velocity_error_norms`,
`divergence_l2`, `kinetic_energy`): batched reductions over boundary and
cell tables precomputed on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.device import pick_device
from navierstokes_project_nm4pde_tpu_torch.fem import quadrature as quad
from navierstokes_project_nm4pde_tpu_torch.fem import reference as ref


@dataclasses.dataclass
class ForceTables:
    """Tables restricted to the obstacle facets."""

    cells_u: torch.Tensor  # [nf, n_loc_u] int64
    cells_p: torch.Tensor  # [nf, dim+1] int64
    grad_u: torch.Tensor  # [nf, q, n_loc_u, dim] physical gradients
    phi_p: torch.Tensor  # [nf, q, dim+1]
    jxw: torch.Tensor  # [nf, q]
    normal: torch.Tensor  # [nf, dim] outward of the FLUID (into the body)


def build_force_tables(space, bt, tag: int, dtype, device) -> ForceTables:
    sel = np.where(bt.tag == tag)[0]
    dev = lambda x: torch.as_tensor(x[sel], dtype=dtype, device=device)  # noqa: E731
    idx = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.int64), device=device
    )
    return ForceTables(
        cells_u=idx(space.cells_u[bt.cell[sel]]),
        cells_p=idx(space.cells_p[bt.cell[sel]]),
        grad_u=dev(bt.grad_u),
        phi_p=dev(bt.phi_p),
        jxw=dev(bt.jxw),
        normal=dev(bt.normal),
    )


def forces_2d(ft: ForceTables, u: torch.Tensor, p: torch.Tensor, nu):
    """(drag, lift) from the full stress integral over the obstacle:
    sigma = nu grad(u) - p I against the body-outward normal, with the
    reference's non-symmetric gradient (ref: src/NavierStokes2D.cpp:818-837).

    An ensemble passes u [n, 2, B], p [n_p, B] and nu a [B] tensor and gets
    [B] drag and lift."""
    u_e = u[ft.cells_u]  # [f, n, dim, *B]
    p_e = p[ft.cells_p]
    gu = torch.einsum("fqid,fic...->fqcd...", ft.grad_u, u_e)  # grad u [c, d]
    p_q = torch.einsum("fqi,fi...->fq...", ft.phi_p, p_e)
    n = -ft.normal  # body-outward normal
    ex = (None,) * (p.dim() - 1)
    trac = nu * torch.einsum("fqcd...,fd->fqc...", gu, n) - (
        p_q[:, :, None] * n[(slice(None), None, slice(None)) + ex]
    )
    force = torch.einsum("fqc...,fq->c...", trac, ft.jxw)
    return force[0], force[1]


def forces_3d(ft: ForceTables, u: torch.Tensor, p: torch.Tensor, nu, rho=1.0):
    """(drag, lift) via the DFG 3D tangent-derivative formula with the
    reference's corrected contraction d(u.t)/dn = t . grad u . n (see the
    reference's `forces_3d` docstring for the deviation it documents).

    An ensemble passes u [n, 3, B], p [n_p, B] and nu a [B] tensor (each
    member's viscous force with its own nu) and gets [B] drag and lift."""
    u_e = u[ft.cells_u]
    p_e = p[ft.cells_p]
    gu = torch.einsum("fqid,fic...->fqcd...", ft.grad_u, u_e)  # du_c/dx_d
    p_q = torch.einsum("fqi,fi...->fq...", ft.phi_p, p_e)
    n = -ft.normal
    nx, ny = n[:, 0], n[:, 1]
    t = torch.stack([ny, -nx, torch.zeros_like(nx)], dim=1)
    t2 = torch.sum(t * t, dim=1)
    tgn = torch.einsum("fc,fqcd...,fd->fq...", t / t2[:, None], gu, n)
    ex = (None,) * (p.dim() - 1)
    nx_, ny_ = nx[(slice(None), None) + ex], ny[(slice(None), None) + ex]
    jxw = ft.jxw[(Ellipsis,) + ex]
    drag = torch.sum((rho * nu * tgn * ny_ - p_q * nx_) * jxw, dim=(0, 1))
    lift = -torch.sum((rho * nu * tgn * nx_ + p_q * ny_) * jxw, dim=(0, 1))
    return drag, lift


def drag_lift_coefficients(drag, lift, mean_velocity, diameter=0.1, span=None, rho=1.0):
    """c_d = 2 drag / (rho U^2 D [H])."""
    denom = rho * mean_velocity**2 * diameter
    if span is not None:
        denom = denom * span
    return 2.0 * drag / denom, 2.0 * lift / denom


@dataclasses.dataclass
class PointProbe:
    cells_p: torch.Tensor  # [n_pts, dim+1] vertex ids of the containing cell
    bary: torch.Tensor  # [n_pts, dim+1] barycentric weights

    def pressure(self, p: torch.Tensor) -> torch.Tensor:
        """[n_pts] values of p [n_p], or [n_pts, B] of p [n_p, B]."""
        return torch.einsum("ki...,ki->k...", p[self.cells_p], self.bary)


def build_point_probe(space, geom, points, dtype, device) -> PointProbe:
    """Host-side point location + P1 interpolation weights.  A point
    outside the mesh raises ValueError."""
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    mesh = space.mesh
    cells, bary = [], []
    v0 = mesh.coords[mesh.cells[:, 0]]
    for x in pts:
        xi = np.einsum("eij,ej->ei", geom.Jinv, x[None, :] - v0)
        lam = np.concatenate([(1.0 - xi.sum(axis=1))[:, None], xi], axis=1)
        ok = np.all(lam >= -1e-9, axis=1)
        if np.any(ok):
            e = int(np.argmax(ok))
        else:
            e = int(np.argmax(lam.min(axis=1)))
            violation = float(-lam[e].min())
            if violation > 1e-6:
                raise ValueError(
                    f"probe point {x} lies outside the mesh (barycentric "
                    f"violation {violation:.2e})"
                )
        cells.append(mesh.cells[e])
        bary.append(lam[e])
    return PointProbe(
        cells_p=torch.as_tensor(np.array(cells, np.int64), device=device),
        bary=torch.as_tensor(np.array(bary), dtype=dtype, device=device),
    )


# ----------------------------------------------------------------------
# Error norms (manufactured solutions)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ErrorTables:
    """Cell quadrature tables at an elevated degree (the reference uses
    degree + 2; src/Convergence3D.cpp:772)."""

    cells_u: torch.Tensor  # [E, n_loc_u] int64
    phi_u: torch.Tensor  # [q2, n_loc_u]
    grad_u: torch.Tensor  # [q2, n_loc_u, dim] (reference gradients)
    Jinv: torch.Tensor  # [E, dim, dim]
    jxw: torch.Tensor  # [E, q2]
    qpoints: torch.Tensor  # [E, q2, dim] physical quadrature points


def build_error_tables(space, geom, degree: int = 5, dtype=torch.float32, device=None) -> ErrorTables:
    """The tables of `space`'s cells at a `degree` rule, on `device` (None:
    the card)."""
    device = pick_device(device)
    dim = space.dim
    pts, w = quad.cell_rule(dim, degree)
    mesh = space.mesh
    v0 = mesh.coords[mesh.cells[:, 0]]
    J = np.transpose(
        mesh.coords[mesh.cells][:, 1:, :] - mesh.coords[mesh.cells][:, :1, :],
        (0, 2, 1),
    )
    qp = v0[:, None, :] + np.einsum("eij,qj->eqi", J, pts)
    jxw = geom.detJ[:, None] * w[None, :]
    dev = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    return ErrorTables(
        cells_u=torch.as_tensor(np.asarray(space.cells_u, np.int64), device=device),
        phi_u=dev(ref.p2_shape(pts, dim)),
        grad_u=dev(ref.p2_grad(pts, dim)),
        Jinv=dev(geom.Jinv),
        jxw=dev(jxw),
        qpoints=dev(qp),
    )


def velocity_error_norms(et: ErrorTables, u: torch.Tensor, exact_u, exact_grad_u, t):
    """(L2, H1) velocity error norms at time t against callables
    `exact_u(x, t) -> [..., dim]` and `exact_grad_u(x, t) -> [..., dim, dim]`.
    H1 is the full norm sqrt(L2^2 + |.|_H1^2), deal.II's `H1_norm` as the
    reference uses it (src/main_convergence3D.cpp:53-54)."""
    u_e = u[et.cells_u]  # [E, n, dim]
    u_q = torch.einsum("qi,eic->eqc", et.phi_u, u_e)
    gu_q = torch.einsum("qik,ekd,eic->eqcd", et.grad_u, et.Jinv, u_e)
    du = u_q - exact_u(et.qpoints, t)
    dg = gu_q - exact_grad_u(et.qpoints, t)
    l2sq = torch.sum(et.jxw * torch.sum(du * du, dim=-1))
    h1semisq = torch.sum(et.jxw * torch.sum(dg * dg, dim=(-1, -2)))
    return torch.sqrt(l2sq), torch.sqrt(l2sq + h1semisq)


def divergence_l2(et: ErrorTables, u: torch.Tensor):
    """||div u_h||_L2 (solution-quality telemetry)."""
    u_e = u[et.cells_u]
    gu_q = torch.einsum("qik,ekd,eic->eqcd", et.grad_u, et.Jinv, u_e)
    div = torch.diagonal(gu_q, dim1=-2, dim2=-1).sum(-1)
    return torch.sqrt(torch.sum(et.jxw * div * div))


def kinetic_energy(et: ErrorTables, u: torch.Tensor):
    """0.5 int |u_h|^2."""
    u_e = u[et.cells_u]
    u_q = torch.einsum("qi,eic->eqc", et.phi_u, u_e)
    return 0.5 * torch.sum(et.jxw * torch.sum(u_q * u_q, dim=-1))
