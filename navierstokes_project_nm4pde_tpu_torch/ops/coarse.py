"""Additive two-level preconditioner for the frozen Schur operator.

The counterpart of the reference's `ops/coarse.py` on its frozen path
(`build_coarse_schur(with_plan=False)`, `host_coarse_dense`, `cho_solve_c`,
`twolevel_apply_additive_g`): aggregates of `agg` consecutive pressure
nodes (spatially compact after the RCM reorder), so restriction is a
reshape + sum and prolongation a repeat.  The dense coarse matrix is
assembled and Cholesky-factorised once on the host in float64.

    z = omega D^-1 r + R^T Sc^-1 R r
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class CoarseSchur:
    nc: int  # coarse rows
    agg: int  # aggregate size
    n_pad: int  # nc * agg


def build_coarse_schur(n_p: int, agg: int = 24) -> CoarseSchur:
    nc = (n_p + agg - 1) // agg
    return CoarseSchur(nc=nc, agg=agg, n_pad=nc * agg)


def host_coarse_dense(
    host: dict, vals_flat: np.ndarray, nc: int, agg: int
) -> np.ndarray:
    """Sc = R S1 R^T from the host slot layout, symmetrised and
    Tikhonov-shifted for S1's constant null space."""
    keep = host["smask"]
    a = host["srow"][keep] // agg
    b = host["scol"][keep] // agg
    Sc = np.zeros((nc, nc))
    np.add.at(Sc, (a, b), vals_flat[keep])
    Sc = 0.5 * (Sc + Sc.T)
    shift = 1e-6 * np.trace(Sc) / nc
    return Sc + shift * np.eye(nc)


# Every function below takes r [n] or [n, B] (one column per ensemble
# member; the coarse factor is shared).
def restrict(cs: CoarseSchur, r: torch.Tensor) -> torch.Tensor:
    pad = cs.n_pad - r.shape[0]
    rp = torch.nn.functional.pad(r, (0, 0) * (r.dim() - 1) + (0, pad)) if pad else r
    return rp.reshape(cs.nc, cs.agg, *r.shape[1:]).sum(dim=1)


def prolong(cs: CoarseSchur, rc: torch.Tensor, n_p: int) -> torch.Tensor:
    return torch.repeat_interleave(rc, cs.agg, dim=0)[:n_p]


def cho_solve_c(cho_L: torch.Tensor):
    """Coarse solve from a dense lower Cholesky factor."""

    def solve(rc):
        R = rc.reshape(rc.shape[0], -1)
        return torch.cholesky_solve(R, cho_L, upper=False).reshape(rc.shape)

    return solve


def twolevel_apply_additive_g(
    cs: CoarseSchur, solve_c, inv_diag: torch.Tensor, r: torch.Tensor,
    omega: float = 0.7,
) -> torch.Tensor:
    """z = omega D^-1 r + R^T Sc^-1 R r (symmetric: safe inside CG; no S
    applies)."""
    zc = solve_c(restrict(cs, r))
    d = inv_diag.reshape((-1,) + (1,) * (r.dim() - 1))
    return omega * d * r + prolong(cs, zc, r.shape[0])
