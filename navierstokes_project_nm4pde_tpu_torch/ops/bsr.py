"""Assembled constant operators (plain PyTorch): the divergence D, the
gradient G = -D^T and the constant velocity block K = M/dt + nu A.

The counterpart of the reference's `ops/bsr.py` (`_divergence_coo`,
`build_divergence_bsr`, `build_gradient_bsr`, `apply_bsr`,
`build_velocity_kbsr`, `apply_bsr_scalar`).  The operators and their values
are the same (assembled once on the host in float64: D from the divergence
ELL, K from the element matrices with scipy); the storage is not.  The reference grouped nodes into
dense supernode blocks because the TPU gather is row-rate bound; here each
apply is a COO gather of the source rows, a per-entry product, and the
deterministic segmented sum of `ops/scatter.py` over the target rows.  A
hand-written SpMV kernel for these is later work.
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


@dataclasses.dataclass
class CSRMatrix:
    """y[r, o] = sum_{k: rows[k] = r} sum_i vals[k, o, i] x[cols[k], i]."""

    cols: torch.Tensor  # [nnz] int64 source rows
    vals: torch.Tensor  # [nnz, Cout, Cin]
    plan: SegmentPlan  # nnz entries -> n_rows target rows
    n_rows: int


def build_csr(rows, cols, vals, n_rows: int, dtype, device) -> CSRMatrix:
    """From COO triples (duplicates already merged); `vals` [nnz, Cout, Cin]."""
    vals = np.asarray(vals)
    return CSRMatrix(
        cols=torch.as_tensor(np.asarray(cols, np.int64), device=device),
        vals=torch.as_tensor(vals, dtype=dtype, device=device),
        plan=build_segment_plan(np.asarray(rows), n_rows, device=device),
        n_rows=n_rows,
    )


def apply_csr(m: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x: [n_src, Cin] -> [n_rows, Cout] (n_src rows of x)."""
    xs = x.index_select(0, m.cols)  # [nnz, Cin]
    contrib = (m.vals * xs[:, None, :]).sum(dim=-1)  # [nnz, Cout]
    return apply_segment_plan(m.plan, contrib)


def apply_csr_scalar(m: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[:, c] = A x[:, c] for every channel c of x [n_src, C], with A a
    scalar-block matrix (vals [nnz, 1, 1]): the component-diagonal K serves
    all channels of the velocity, or of a block of velocities, at once."""
    return apply_segment_plan(m.plan, m.vals[:, 0] * x.index_select(0, m.cols))


def build_velocity_kcsr(space, geom, tables, nu: float, dt: float, dtype, device) -> CSRMatrix:
    """The constant velocity block K = M/dt + nu A, assembled once from the
    element matrices (scalar blocks: K is component-diagonal).  Valid as
    the whole velocity operator when convection is explicit, and as its
    constant part under IMEX, with BDF1."""
    import scipy.sparse as sp

    n, nloc = space.n_unodes, tables.MHAT.shape[0]
    GKd = np.einsum("ekd,eld->ekl", geom.Jinv, geom.Jinv) * geom.detJ[:, None, None]
    K_e = (geom.detJ / dt)[:, None, None] * tables.MHAT[None]
    K_e = K_e + nu * np.einsum("ekl,klij->eij", GKd, tables.AHAT)
    cells = np.asarray(space.cells_u, dtype=np.int64)
    rows = np.repeat(cells, nloc, axis=1).reshape(-1)
    cols = np.tile(cells, (1, nloc)).reshape(-1)
    csr = sp.csr_matrix((K_e.reshape(-1), (rows, cols)), shape=(n, n))
    csr.sum_duplicates()
    coo = csr.tocoo()
    return build_csr(coo.row, coo.col, coo.data[:, None, None], n, dtype, device)


def _divergence_coo(schur_host: dict):
    """COO triples of D from the host ELL (`schur_host["D_cols"/"D_vals"]`,
    [n_p, Wd] cols / [n_p, Wd, dim] vals, duplicates pre-merged)."""
    D_cols, D_vals = schur_host["D_cols"], schur_host["D_vals"]
    n_p, Wd = D_cols.shape
    keep = (D_vals != 0.0).any(axis=-1)
    rows = np.broadcast_to(np.arange(n_p)[:, None], (n_p, Wd))[keep]
    return rows, D_cols[keep], D_vals[keep]  # vals [nnz, dim]


def build_divergence_csr(
    schur_host: dict, n_unodes: int, n_pnodes: int, dtype, device
) -> CSRMatrix:
    """D: u [n_unodes, dim] -> D u [n_pnodes, 1]."""
    rows, cols, vals = _divergence_coo(schur_host)
    return build_csr(rows, cols, vals[:, None, :], n_pnodes, dtype, device)


def build_gradient_csr(
    schur_host: dict, n_unodes: int, n_pnodes: int, dtype, device
) -> CSRMatrix:
    """G = -D^T: p [n_pnodes, 1] -> G p [n_unodes, dim]."""
    rows, cols, vals = _divergence_coo(schur_host)
    return build_csr(cols, rows, -vals[:, :, None], n_unodes, dtype, device)
