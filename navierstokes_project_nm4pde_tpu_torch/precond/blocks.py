"""Velocity-block Jacobi data for the projection stepper.

The counterpart of what the reference's projection path reads from
`precond/blocks.py build_precond_state(..., skip_schur=True)`: the inverse
diagonal of F with identity rows on Dirichlet nodes.  The frozen Schur
path brings its own pressure-space data (models/base.py FrozenSchur), so
nothing else of the block-preconditioner family is needed here.
"""

from __future__ import annotations

import torch

from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops


def inv_diag_Fhat(op: ops.NSOperator, nu, dt, conv: ops.ConvectionData | None) -> torch.Tensor:
    """1 / diag(F) on free nodes, 1 on Dirichlet rows: [n_unodes], or
    [n_unodes, B] for a [B] tensor nu (an ensemble)."""
    dF = ops.diag_F(op, nu, dt, conv)
    mask = op.dirichlet_mask.reshape((-1,) + (1,) * (dF.dim() - 1))
    return 1.0 / torch.where(mask, torch.ones_like(dF), dF)
