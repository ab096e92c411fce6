"""Two-level preconditioners for the Schur operator.

The counterpart of the reference's `ops/coarse.py` (`build_coarse_schur`,
`host_coarse_dense`, `coarse_dense`, `coarse_factor`, `coarse_inverse`,
`cho_solve_c`, `inv_solve_c`, `twolevel_apply`, `twolevel_apply_g`,
`twolevel_apply_additive_g`): aggregates of `agg` consecutive pressure
nodes (spatially compact after the spatial reorder), so restriction is a
reshape + sum and prolongation a repeat.  The frozen S1's dense coarse
matrix is assembled once on the host in float64; a per-step S~ (the block
preconditioners, proj_schur="step") reduces its flat ELL values into the
dense [nc, nc] matrix through the plan `build_coarse_schur` builds from the
slot layout, on the device.  Either is Cholesky-factorised or inverted
(one [nc, nc] gemv an application).  The per-step factor (`cholesky_ex`,
no host sync) is applied by two triangular solves (`cho_solve_c`); the
frozen one is inverted once at set-up, W = L^-1 in float64 on the host
(`frozen_cho_w`), and applied as z = W^T (W r) (`cho_w_solve_c`): on the
card by the hand-written `coarse_solve` kernel (`csrc/coarse_kernels.cu`,
two launches, each reading one triangle), on the CPU by its plain version.
Each application of a coarse solve runs in span `precond.coarse_solve`
(`utils/profiling.py`), with its sizes: nc, the columns, the factors (1,
or B), the element size and the form ("chol" or "inv"); a Cholesky
form's also with `impl`, the path it took ("kernel", "plain" or
"cholesky_solve").  `launch_counts` counts the kernel's launches:
float32's under its name, float64's under the name with `_f64`.

    additive:  z = omega D^-1 r + R^T Sc^-1 R r
    V(1,1):    smooth, coarse correction, smooth (two S applies)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.ops import cuda_lib
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    SegmentPlan,
    apply_segment_plan,
    build_segment_plan,
)
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import span

launch_counts = {"coarse_solve": 0, "coarse_solve_f64": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class CoarseSchur:
    nc: int  # coarse rows
    agg: int  # aggregate size
    n_pad: int  # nc * agg
    # flat S~ slots -> the nc * nc dense entries (masked slots dropped);
    # None for the frozen S1, whose coarse matrix is assembled on the host
    plan: SegmentPlan | None = None


def build_coarse_schur(n_p: int, agg: int = 24, host: dict | None = None, device=None) -> CoarseSchur:
    """The aggregation of n_p pressure nodes; with the S~ host slot layout
    `host` (srow, scol, smask), also the plan of `coarse_dense`."""
    nc = (n_p + agg - 1) // agg
    plan = None
    if host is not None:
        a, b = host["srow"] // agg, host["scol"] // agg
        flat = np.where(host["smask"], a * nc + b, nc * nc)  # masked -> dropped
        plan = build_segment_plan(flat, nc * nc, drop_row=nc * nc, device=device)
    return CoarseSchur(nc=nc, agg=agg, n_pad=nc * agg, plan=plan)


def coarse_dense(cs: CoarseSchur, vals_flat: torch.Tensor) -> torch.Tensor:
    """Dense coarse matrix Sc = R S~ R^T from S~'s flat ELL values,
    symmetrised and Tikhonov-shifted for the constant null space: [nc, nc],
    or [B, nc, nc] for one value set a member (vals_flat [n_slots, B])."""
    if vals_flat.dim() == 2:
        Sc = apply_segment_plan(cs.plan, vals_flat).T.reshape(-1, cs.nc, cs.nc)
        Sc = 0.5 * (Sc + Sc.transpose(1, 2))
        shift = 1e-6 * torch.diagonal(Sc, dim1=1, dim2=2).sum(-1) / cs.nc
        return Sc + shift[:, None, None] * torch.eye(cs.nc, dtype=Sc.dtype, device=Sc.device)
    Sc = apply_segment_plan(cs.plan, vals_flat[:, None])[:, 0].view(cs.nc, cs.nc)
    Sc = 0.5 * (Sc + Sc.T)
    shift = 1e-6 * torch.trace(Sc) / cs.nc
    return Sc + shift * torch.eye(cs.nc, dtype=Sc.dtype, device=Sc.device)


def coarse_factor(cs: CoarseSchur, vals_flat: torch.Tensor) -> torch.Tensor:
    """The per-step lower Cholesky factor of the dense coarse matrix (a
    batched `cholesky_ex` over [B, nc, nc] for one matrix a member)."""
    return torch.linalg.cholesky_ex(coarse_dense(cs, vals_flat)).L


def coarse_inverse(cs: CoarseSchur, vals_flat: torch.Tensor) -> torch.Tensor:
    """The dense inverse of the coarse matrix (through its Cholesky factor)."""
    return torch.cholesky_inverse(coarse_factor(cs, vals_flat))


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
# member; the coarse factor and the diagonal shared, or one a member).
def restrict(cs: CoarseSchur, r: torch.Tensor) -> torch.Tensor:
    pad = cs.n_pad - r.shape[0]
    rp = torch.nn.functional.pad(r, (0, 0) * (r.dim() - 1) + (0, pad)) if pad else r
    return rp.reshape(cs.nc, cs.agg, *r.shape[1:]).sum(dim=1)


def prolong(cs: CoarseSchur, rc: torch.Tensor, n_p: int) -> torch.Tensor:
    return torch.repeat_interleave(rc, cs.agg, dim=0)[:n_p]


def cho_solve_c(cho_L: torch.Tensor):
    """Coarse solve from a dense lower Cholesky factor made on the device
    ([nc, nc] shared, or [B, nc, nc] for the B columns of rc [nc, B]): two
    triangular solves (`torch.cholesky_solve`)."""
    nc, factors = cho_L.shape[-1], cho_L.shape[0] if cho_L.dim() == 3 else 1
    s = cho_L.element_size()

    def solve(rc):
        with span("precond.coarse_solve", nc=nc, cols=rc.numel() // nc, factors=factors, itemsize=s, form="chol",
                  impl="cholesky_solve"):
            if cho_L.dim() == 3:
                return torch.cholesky_solve(rc.T[:, :, None], cho_L, upper=False)[:, :, 0].T
            R = rc.reshape(rc.shape[0], -1)
            return torch.cholesky_solve(R, cho_L, upper=False).reshape(rc.shape)

    return solve


def frozen_cho_w(Sc: np.ndarray, dtype: torch.dtype, device=None) -> torch.Tensor:
    """The operand of `cho_w_solve_c` for the frozen coarse matrix Sc (float64,
    [nc, nc]), built once in float64 on the host and rounded once to
    `dtype`: [nc, ld] holding W = L^-1 (L Sc's lower Cholesky factor) in its
    lower triangle, diagonal included, and W^T's strict upper part above
    it; ld is nc rounded up to a multiple of 4, the columns past nc zero."""
    nc = Sc.shape[0]
    L = torch.as_tensor(np.linalg.cholesky(Sc))
    W = torch.linalg.solve_triangular(L, torch.eye(nc, dtype=L.dtype), upper=False)
    M = torch.zeros((nc, -(-nc // 4) * 4), dtype=L.dtype)
    M[:, :nc] = torch.tril(W) + torch.tril(W, -1).T
    return M.to(dtype=dtype, device=device)


def coarse_solve_plain(cho_w: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch `coarse_solve`: z = W^T (W rc), rc [nc] or [nc, cols],
    from `frozen_cho_w`'s packed W."""
    nc = cho_w.shape[0]
    M = cho_w[:, :nc]
    R = rc.reshape(nc, -1)
    return (torch.triu(M) @ (torch.tril(M) @ R)).reshape(rc.shape)


def coarse_solve(cho_w: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """z = Sc^-1 rc = W^T (W rc) for rc [nc] or [nc, cols]: the hand-written
    kernel on a CUDA tensor (two launches), the plain version on a CPU one."""
    if rc.device.type == "cpu":
        return coarse_solve_plain(cho_w, rc)
    if rc.device.type != "cuda":
        raise ValueError(f"coarse_solve: unsupported device {rc.device}")
    nc, ld = cho_w.shape[0], cho_w.shape[-1]
    if (
        rc.dtype not in cuda_lib.SUFFIX or cho_w.dtype != rc.dtype or cho_w.device != rc.device
        or cho_w.dim() != 2 or ld < nc or ld % 4 or cho_w.data_ptr() % 16
        or not (cho_w.is_contiguous() and rc.is_contiguous())
        or rc.dim() not in (1, 2) or rc.shape[0] != nc
    ):
        raise ValueError(
            f"coarse_solve: expected a contiguous float32 or float64 [{nc}] or [{nc}, cols] "
            f"tensor beside a contiguous, 16-byte aligned [{nc}, ld] operand of its dtype and "
            f"device (ld a multiple of 4, at least {nc}); got {rc.dtype} {tuple(rc.shape)} on "
            f"{rc.device} and {cho_w.dtype} {tuple(cho_w.shape)} on {cho_w.device}"
        )
    cols = rc.numel() // nc
    y = torch.empty((nc, cols), dtype=rc.dtype, device=rc.device)  # W rc, the second launch's input
    z = torch.empty_like(rc)
    entry = f"ns_coarse_solve_{cuda_lib.SUFFIX[rc.dtype]}"
    stream = torch.cuda.current_stream(rc.device).cuda_stream
    cuda_lib.check(
        getattr(cuda_lib.load(), entry)(
            cho_w.data_ptr(), rc.data_ptr(), y.data_ptr(), z.data_ptr(), nc, ld, cols, stream,
        ),
        entry,
    )
    launch_counts[cuda_lib.count_key("coarse_solve", rc.dtype)] += 2
    return z


def cho_w_solve_c(cho_w: torch.Tensor):
    """Coarse solve of the frozen factor, from `frozen_cho_w`'s operand
    [nc, ld], shared by the columns of rc [nc] or [nc, B] (`coarse_solve`)."""
    nc, s = cho_w.shape[0], cho_w.element_size()
    impl = "kernel" if cho_w.device.type == "cuda" else "plain"

    def solve(rc):
        with span("precond.coarse_solve", nc=nc, cols=rc.numel() // nc, factors=1, itemsize=s, form="chol",
                  impl=impl):
            return coarse_solve(cho_w, rc)

    return solve


def inv_solve_c(Sc_inv: torch.Tensor):
    """Coarse solve from the dense inverse of the coarse matrix: one
    [nc, nc] product."""
    nc, s = Sc_inv.shape[-1], Sc_inv.element_size()

    def solve(rc):
        with span("precond.coarse_solve", nc=nc, cols=rc.numel() // nc, factors=1, itemsize=s, form="inv"):
            return (Sc_inv @ rc.reshape(rc.shape[0], -1)).reshape(rc.shape)

    return solve


def twolevel_apply_g(
    cs: CoarseSchur, solve_c, S, inv_diag: torch.Tensor, r: torch.Tensor,
    omega: float = 0.7, post: bool = True,
) -> torch.Tensor:
    """Multiplicative two-level application z ~ S^-1 r: damped Jacobi,
    coarse correction of the residual and, with `post`, a second Jacobi
    sweep (the symmetric V(1,1), safe inside CG)."""
    d = _spread_diag(inv_diag, r)
    z = omega * d * r
    zc = solve_c(restrict(cs, r - S(z)))
    z = z + prolong(cs, zc, r.shape[0])
    if post:
        z = z + omega * d * (r - S(z))
    return z


def twolevel_apply(
    cs: CoarseSchur, cho_L: torch.Tensor, S, inv_diag: torch.Tensor, r: torch.Tensor,
    omega: float = 0.7, post: bool = True,
) -> torch.Tensor:
    """`twolevel_apply_g` with the coarse solve of a Cholesky factor."""
    return twolevel_apply_g(cs, cho_solve_c(cho_L), S, inv_diag, r, omega, post)


def twolevel_apply_additive_g(
    cs: CoarseSchur, solve_c, inv_diag: torch.Tensor, r: torch.Tensor,
    omega: float = 0.7,
) -> torch.Tensor:
    """z = omega D^-1 r + R^T Sc^-1 R r (symmetric: safe inside CG; no S
    applies)."""
    zc = solve_c(restrict(cs, r))
    d = _spread_diag(inv_diag, r)
    return omega * d * r + prolong(cs, zc, r.shape[0])


def _spread_diag(inv_diag: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A diagonal [n] (shared) or [n, B] (one a member) against r."""
    if inv_diag.dim() == r.dim():
        return inv_diag
    return inv_diag.reshape((-1,) + (1,) * (r.dim() - 1))
