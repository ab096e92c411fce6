"""Constant reference-element tensors for matrix-free operator application.

The port's copy of the JAX package's `ops/tables.py` (numpy only), on the
port's own `fem/` copies.

This is the TPU replacement for the reference's per-cell `FEValues` loop
(ref: src/NavierStokes2D.cpp:209-313): every bilinear form on affine simplices
factors into (tiny constant reference tensor) x (per-element geometry), so
operator application becomes a handful of shared matmuls over the element
batch -- exactly what the MXU wants.

Tensors (nu = n_loc_u P2 nodes, np = dim+1 P1 nodes, q = quadrature points):

  PHI_U  [q, nu]          P2 values
  GRAD_U [q, nu, dim]     P2 reference gradients
  PHI_P  [q, np]          P1 values
  W      [q]              quadrature weights (sum = reference measure)
  MHAT   [nu, nu]         reference scalar mass:     sum_q w phi_i phi_j
  MPHAT  [np, np]         reference pressure mass
  AHAT   [dim, dim, nu, nu]  split stiffness: AHAT[k,l] = sum_q w g_ik g_jl
  BHAT   [dim, np, nu]    split divergence:  BHAT[k,i,j] = sum_q w p_i g_jk

Per-element factors (computed from Jinv/detJ):
  mass:       detJ * MHAT
  stiffness:  detJ * sum_kl GK[e,k,l] AHAT[k,l],  GK = Jinv @ Jinv^T
  divergence: detJ * sum_k Jinv[e,k,c] BHAT[k]    (component c)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from navierstokes_project_nm4pde_tpu_torch.fem import quadrature as quad
from navierstokes_project_nm4pde_tpu_torch.fem import reference as ref


@dataclasses.dataclass
class RefTables:
    dim: int
    PHI_U: np.ndarray
    GRAD_U: np.ndarray
    PHI_P: np.ndarray
    W: np.ndarray
    MHAT: np.ndarray
    MPHAT: np.ndarray
    AHAT: np.ndarray
    BHAT: np.ndarray


def build_ref_tables(dim: int, degree: int = 5) -> RefTables:
    pts, w = quad.cell_rule(dim, degree)
    phi_u = ref.p2_shape(pts, dim)
    grad_u = ref.p2_grad(pts, dim)
    phi_p = ref.p1_shape(pts, dim)

    mhat = np.einsum("q,qi,qj->ij", w, phi_u, phi_u)
    mphat = np.einsum("q,qi,qj->ij", w, phi_p, phi_p)
    ahat = np.einsum("q,qik,qjl->klij", w, grad_u, grad_u)
    bhat = np.einsum("q,qi,qjk->kij", w, phi_p, grad_u)
    return RefTables(
        dim=dim,
        PHI_U=phi_u,
        GRAD_U=grad_u,
        PHI_P=phi_p,
        W=w,
        MHAT=mhat,
        MPHAT=mphat,
        AHAT=ahat,
        BHAT=bhat,
    )
