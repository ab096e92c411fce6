"""The DFG 3D-Z duct problem for the reference: the inflow, the boundary
conditions and the functionals (drag and lift coefficients on the
cylinder, the pressure difference between the two probes).

The benchmark's own copy of what the configuration states (Schaefer and
Turek 1996, 3D-2Z; the upstream project's `include/NavierStokes3D.hpp:17-81`
inflow case 2, which the program's `models/cylinder3d.py:33-61` also
follows): duct 2.5 x 0.41 x 0.41, cylinder of diameter 0.1, inflow
16 u_m y z (H - y)(H - z) / H^4, mean velocity 4 u_m / 9, no slip on the
walls (tag 2) and the cylinder (tag 3), do-nothing outflow (tag 1).

Drag and lift follow the DFG tangent-derivative formula: with n the
normal out of the cylinder into the fluid and t = (n_y, -n_x, 0),
  drag =  int_S (rho nu (t . grad u . n) / |t|^2 n_y - p n_x) dS,
  lift = -int_S (rho nu (t . grad u . n) / |t|^2 n_x + p n_y) dS,
  c = 2 force / (rho U^2 D H).
On a P2 / P1 field the integrand is linear on each face, so the face's
area times the value at its centroid integrates it exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from nsbench.reference.fem import P2Space, RefOperator, face_centroid_derivatives

DIRICHLET_TAGS = (0, 2, 3)
INLET, WALLS, CYLINDER = 0, 2, 3


def mean_velocity(problem: dict) -> float:
    """The inflow's mean velocity, 4 u_m / 9."""
    return 4.0 * float(problem["u_m"]) / 9.0


def fixed_nodes(coords: np.ndarray, problem: dict) -> np.ndarray:
    """The nodes at `coords` [n, 3] that the Dirichlet conditions hold: on
    the inlet (x = 0) or the walls (y, z = 0 or H) to within 1e-9, or on
    the cylinder, whose faces' chord midpoints lie inside its radius."""
    H, eps = float(problem["height"]), 1e-9
    cx, cy, R = problem["cylinder"]
    r = np.hypot(coords[:, 0] - cx, coords[:, 1] - cy)
    return (
        (coords[:, 0] < eps) | (coords[:, 1] < eps) | (coords[:, 1] > H - eps)
        | (coords[:, 2] < eps) | (coords[:, 2] > H - eps) | (r < R * (1.0 + eps))
    )


class DFG3D:
    """The problem's data on a P2Space, for one RefOperator's precision."""

    def __init__(self, op: RefOperator, problem: dict):
        self.op = op
        self.u_m = float(problem["u_m"])
        self.H = float(problem["height"])
        self.D = float(problem["diameter"])
        self.rho = float(problem.get("rho", 1.0))
        self.U = mean_velocity(problem)
        sp = op.space
        # inflow on the inlet's nodes that no wall or cylinder face holds
        g = np.zeros((sp.n_u, 3))
        inlet = np.setdiff1d(sp.boundary_nodes([INLET]), sp.boundary_nodes([WALLS, CYLINDER]))
        y, z = sp.node_coords[inlet, 1], sp.node_coords[inlet, 2]
        H = self.H
        g[inlet, 0] = 16.0 * self.u_m * y * z * (H - y) * (H - z) / H**4
        self.g = op.T(g)
        # the cylinder's faces
        faces = sp.bface_verts[sp.bface_tag == CYLINDER]
        cell, opp = sp.face_parents(faces)
        x = sp.coords[faces]
        nrm = np.cross(x[:, 1] - x[:, 0], x[:, 2] - x[:, 0])
        area = 0.5 * np.linalg.norm(nrm, axis=1)
        nrm /= (2.0 * area)[:, None]
        away = x[:, 0] - sp.coords[sp.cells[cell, opp]]  # from the cell's far vertex to the face
        nrm *= np.sign(np.sum(nrm * away, axis=1))[:, None]  # out of the fluid
        n = -nrm  # out of the cylinder, into the fluid
        dphi = face_centroid_derivatives()[opp]  # [f, m, j]
        gradphi = np.einsum("fmj,fmd->fjd", dphi, sp.gradlam[cell])  # [f, j, d]
        t = np.stack([n[:, 1], -n[:, 0], np.zeros(len(n))], axis=1)
        t /= np.sum(t * t, axis=1)[:, None]
        # (t . grad u . n) = sum_jc u_jc t_c (grad phi_j . n)
        self.f_cells_u = torch.as_tensor(sp.cells_u[cell], device=op.device)
        self.f_tgn = op.T(np.einsum("fc,fj->fjc", t, np.einsum("fjd,fd->fj", gradphi, n)) * area[:, None, None])
        self.f_verts = torch.as_tensor(faces, device=op.device)
        self.f_area_n = op.T(area[:, None] * n)  # [f, 3]
        self.third = op.T(np.full((3, 1), 1.0 / 3.0))
        # the probes' cells and P1 weights
        self.probe_cells, self.probe_w = [], []
        for pt in problem["probes"]:
            lam = np.einsum("emc,ec->em", sp.gradlam, np.asarray(pt)[None] - sp.coords[sp.cells[:, 0]])
            lam[:, 0] = 1.0 - lam[:, 1:].sum(axis=1)
            e = int(np.argmax(lam.min(axis=1)))
            if lam[e].min() < -1e-9:
                raise ValueError(f"probe {pt} lies outside the mesh")
            self.probe_cells.append(sp.cells[e])
            self.probe_w.append(lam[e])
        self.probe_cells = torch.as_tensor(np.array(self.probe_cells), device=op.device)
        self.probe_w = op.T(np.array(self.probe_w))

    def diagnostics(self, u: torch.Tensor, p: torch.Tensor, nu: float) -> dict:
        """c_d, c_l and delta_p of one field u [n_u, 3], p [n_p]."""
        op = self.op
        f = self.f_tgn.shape[0]
        tgn_area = op.mm(self.f_tgn.reshape(f, 1, 30), u[self.f_cells_u].reshape(f, 30, 1))[:, 0, 0]
        p_bar = op.mm(p[self.f_verts][:, None, :], self.third)[:, 0, 0]
        p_area_n = p_bar[:, None] * self.f_area_n  # the face's mean p, times area n
        nx, ny = self.f_area_n[:, 0], self.f_area_n[:, 1]
        area = torch.linalg.norm(self.f_area_n, dim=1)
        drag = torch.sum(self.rho * nu * tgn_area * ny / area - p_area_n[:, 0])
        lift = -torch.sum(self.rho * nu * tgn_area * nx / area + p_area_n[:, 1])
        scale = 2.0 / (self.rho * self.U**2 * self.D * self.H)
        pv = op.mm(p[self.probe_cells][:, None, :], self.probe_w[:, :, None])[:, 0, 0]
        return dict(c_d=float(scale * drag), c_l=float(scale * lift), delta_p=float(pv[0] - pv[1]))


def build(mesh_arrays, problem: dict, precision: str = "float64", device="cpu"):
    """(P2Space, RefOperator, DFG3D) of the handed mesh arrays."""
    space = P2Space(*mesh_arrays)
    op = RefOperator(space, DIRICHLET_TAGS, precision=precision, device=device)
    return space, op, DFG3D(op, problem)
