"""Matrix-free velocity operator F = M/dt + nu A + C(w), the saddle-point
operator, and the static per-mesh operator data (PyTorch).

The counterpart of the reference's `ops/operators.py`: the host side of
`build_operator` (geometry factors, reference tables, global diagonals,
the divergence ELL, and the Schur host tables: the frozen S1's, or the
per-step assembly's), the element gathers and reductions,
`convection_setup` with the fold (full, or convection only for the macro
K/C split, and weighted per cell under IMEX) or without it
(numerics.fold_elem=False: every apply evaluates K = M/dt + nu A and C(w)
from the quadrature tables, with no per-step F_e), the element
passes (`apply_rhs_and_r0`, `apply_F` with or without convection,
`apply_divergence_e`, `apply_gradient_e`, the explicit rhs
`apply_convection_self`), the constant blocks (`apply_mass`,
`apply_stiffness`, `apply_pressure_mass`), the monolithic stepper's
saddle-point operator `apply_system` (F and G in one element pass and one
reduction, the divergence rows from the same gather, Dirichlet rows
masked) and the IMEX fine subset (`ImexTables`, `convection_fine_fold`,
`apply_convection_fine`).  D and G are the assembled forms of
`ops/bsr.py` unless the configuration asks for the element passes
(`div` / `grad` None).  With `BackflowTables` (an open boundary's
backflow stabilisation), `convection_setup` adds the facet term's
diagonal and its coefficients, which `apply_F`, `apply_system`,
`apply_rhs_and_r0` and `apply_convection_self` apply on the facets.

Layout: velocity `u[n_unodes, dim]`, pressure `p[n_pnodes]`; every array
lives on the device passed to `build_operator`.  An ensemble carries its
B members on a trailing axis (`u[n_unodes, dim, B]`, `p[n_pnodes, B]`,
nu a [B] tensor): the element passes take any trailing axes and move
them as packed channels (C = dim * B, component-major) through the slot
gather and reduce of `ops/onehot.py` (kernels D and C on the card).  The
per-member element matrices are then held as F_e[j, e, i, b] = F_e^(b)[e, i, j]
([nloc, E, nloc, B]), their product is kernel G (`onehot.member_product`;
`apply_F` hands it the node rows, so it gathers them itself), and D and G
are element passes.

A cell-sharded operator (`parallel/sharding.py`) holds one rank's block
of the cells and its process group: every node reduce (`scatter_u`,
`scatter_p`) then all-reduces the rank's partial vector over the group.
"""

from __future__ import annotations

import dataclasses
import functools

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
from navierstokes_project_nm4pde_tpu_torch.ops.onehot import (
    OneHotPlans,
    build_onehot_plans,
    member_product,
    onehot_gather,
    onehot_reduce,
)
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    SegmentPlan,
    apply_segment_plan,
    build_segment_plan,
)
from navierstokes_project_nm4pde_tpu_torch.ops.schur_ell import (
    SchurELL,
    build_schur_ell,
    build_schur_frozen,
    schur_from_host,
)
from navierstokes_project_nm4pde_tpu_torch.ops.tables import build_ref_tables
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import setup_phase


@dataclasses.dataclass
class NSOperator:
    """Static per-mesh operator data (tensors on one device)."""

    cells_u: torch.Tensor  # [E, n_loc_u] int64
    cells_p: torch.Tensor  # [E, dim + 1] int64
    plan_p: SegmentPlan  # [E * (dim + 1)] pressure element slots -> [n_pnodes]
    detJ: torch.Tensor  # [E]
    Jinv: torch.Tensor  # [E, dim, dim]
    GKd: torch.Tensor  # [E, dim, dim] = detJ * Jinv @ Jinv^T
    W: torch.Tensor  # [q] quadrature weights
    PHI_U: torch.Tensor  # [q, nloc]
    GRAD_U: torch.Tensor  # [q, nloc, dim]
    MHAT: torch.Tensor  # [nloc, nloc]
    MPHAT: torch.Tensor  # [nloc_p, nloc_p] reference pressure mass
    AHAT: torch.Tensor  # [dim, dim, nloc, nloc]
    BHAT: torch.Tensor  # [dim, nloc_p, nloc] reference divergence table
    diagM: torch.Tensor  # [n_unodes] mass diagonal (unscaled by dt)
    diagA: torch.Tensor  # [n_unodes] stiffness diagonal (unscaled by nu)
    lumpM: torch.Tensor  # [n_unodes] abs-lumped mass (unscaled by dt)
    diagMp: torch.Tensor  # [n_pnodes] pressure-mass diagonal
    dirichlet_mask: torch.Tensor  # [n_unodes] bool
    div: CSRMatrix | None  # D: [n_unodes, dim] -> [n_pnodes, 1]; None: element pass
    grad: CSRMatrix | None  # G = -D^T: [n_pnodes, 1] -> [n_unodes, dim]; None: element pass
    coarse: CoarseSchur
    # S~'s ELL structure: with its assembly tables when the Schur block is
    # assembled every step (the block preconditioners, proj_schur="step"),
    # or the frozen S1's SpMV layout (its ELL fallback); None when nothing
    # reads it
    schur: SchurELL | None = None
    # frozen SPAI values on S~'s slots (s_solver "spai"/"spai_cg")
    spai_vals: torch.Tensor | None = None
    # the P2 -> P1 two-level velocity structure (f_solver "pmg")
    pmg: object | None = None
    # Per-cell IMEX convection weight [E] (TimeConfig.convection="imex"):
    # 1 keeps the cell's linearised C(w) inside F, 0 moves it to the
    # explicit rhs.  None: fully implicit.
    imex_scale: torch.Tensor | None = None
    # the cell-sharded operator's process group (`parallel/sharding.py`):
    # each rank holds a block of the cells, and every node reduce of an
    # element pass all-reduces the rank's partial vector over the group
    # (the reference's compress()); None on one device
    group: object | None = None

    @functools.cached_property
    def onehot(self) -> OneHotPlans:
        """Velocity element slots <-> [n_unodes] rows, built at first use:
        only the element passes read them (the ensemble step; in a single
        run, only an unfrozen convection diagonal)."""
        with setup_phase("setup.onehot"):
            return build_onehot_plans(
                self.cells_u.cpu().numpy(), self.diagM.shape[0], device=self.cells_u.device
            )

    @functools.cached_property
    def stiff_e(self) -> torch.Tensor:
        """Constant element stiffness GKd:AHAT [E, nloc, nloc] (computed
        once, like the reference's DeviceData.conv_base)."""
        with setup_phase("setup.stiff_e"):
            return torch.einsum("ekl,klij->eij", self.GKd, self.AHAT)

    @property
    def dim(self) -> int:
        return self.Jinv.shape[-1]

    @property
    def n_unodes(self) -> int:
        return self.diagM.shape[0]

    @property
    def n_pnodes(self) -> int:
        return self.diagMp.shape[0]


def build_operator(
    space, geom, dirichlet_mask: np.ndarray, dtype, device, coarse_agg: int = 24,
    device_schur_assembly: bool = False,
):
    """Build the operator and the host Schur dict (float64 numpy: slot
    layout, `diagM`, `D_cols`, `D_vals`).  Returns (op, schur_host).

    device_schur_assembly=False: the frozen projection Schur; the host dict
    holds S1's values `vals1` and `op.schur` is None (the stepper builds
    the SpMV layout only if its ELL fallback runs).  True: S~ is assembled
    every step on the device, so `op.schur` carries the pair-product tables
    and `op.coarse` the plan of the per-step coarse matrix."""
    t = build_ref_tables(space.dim)
    GK = np.einsum("ekd,eld->ekl", geom.Jinv, geom.Jinv)
    GKd = GK * geom.detJ[:, None, None]

    diagM = np.zeros(space.n_unodes)
    diagA = np.zeros(space.n_unodes)
    lumpM = np.zeros(space.n_unodes)
    diagMp = np.zeros(space.n_pnodes)
    mdiag_e = geom.detJ[:, None] * np.diag(t.MHAT)[None, :]
    adiag_e = np.einsum("ekl,kli->ei", GKd, np.einsum("klii->kli", t.AHAT))
    lump_e = geom.detJ[:, None] * np.sum(np.abs(t.MHAT), axis=1)[None, :]
    mpdiag_e = geom.detJ[:, None] * np.diag(t.MPHAT)[None, :]
    np.add.at(diagM, space.cells_u, mdiag_e)
    np.add.at(diagA, space.cells_u, adiag_e)
    np.add.at(lumpM, space.cells_u, lump_e)
    np.add.at(diagMp, space.cells_p, mpdiag_e)

    mask = np.asarray(dirichlet_mask, dtype=bool)
    D_cols, D_vals = _assemble_divergence_ell(space, geom, t)
    schur = None
    if device_schur_assembly:
        schur_host = build_schur_ell(D_cols, D_vals)
        schur = schur_from_host(schur_host, dtype, device, assembly=True)
    else:
        inv1 = np.where(mask, 0.0, 1.0 / diagM)
        schur_host = build_schur_frozen(D_cols, D_vals, inv1, space.n_unodes)
    schur_host["diagM"] = diagM
    schur_host["D_cols"] = D_cols
    schur_host["D_vals"] = D_vals

    dev = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    idx = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)  # noqa: E731
    op = NSOperator(
        cells_u=idx(space.cells_u),
        cells_p=idx(space.cells_p),
        plan_p=build_segment_plan(space.cells_p, space.n_pnodes, device=device),
        detJ=dev(geom.detJ),
        Jinv=dev(geom.Jinv),
        GKd=dev(GKd),
        W=dev(t.W),
        PHI_U=dev(t.PHI_U),
        GRAD_U=dev(t.GRAD_U),
        MHAT=dev(t.MHAT),
        MPHAT=dev(t.MPHAT),
        AHAT=dev(t.AHAT),
        BHAT=dev(t.BHAT),
        diagM=dev(diagM),
        diagA=dev(diagA),
        lumpM=dev(lumpM),
        diagMp=dev(diagMp),
        dirichlet_mask=torch.as_tensor(mask, device=device),
        div=build_divergence_csr(
            schur_host, space.n_unodes, space.n_pnodes, dtype, device
        ),
        grad=build_gradient_csr(
            schur_host, space.n_unodes, space.n_pnodes, dtype, device
        ),
        coarse=build_coarse_schur(
            space.n_pnodes, agg=coarse_agg,
            host=schur_host if device_schur_assembly else None, device=device,
        ),
        schur=schur,
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
    """[n_unodes, *rest] -> [E, n_loc_u, *rest] element view (kernel D on
    the card, the trailing axes packed as channels)."""
    E, nloc = op.cells_u.shape
    y = onehot_gather(op.onehot, u.reshape(u.shape[0], -1).contiguous())
    return y.view(E, nloc, *u.shape[1:])


def scatter_u(op: NSOperator, y_e: torch.Tensor) -> torch.Tensor:
    """[E, n_loc_u, *rest] element contributions -> [n_unodes, *rest]
    (kernel C on the card)."""
    flat = y_e.reshape(op.onehot.n_slots, -1).contiguous()
    return _compress(op, onehot_reduce(op.onehot, flat)).view(op.onehot.n_rows, *y_e.shape[2:])


def gather_p(op: NSOperator, p: torch.Tensor) -> torch.Tensor:
    """[n_pnodes, *rest] -> [E, dim + 1, *rest] (a plain gather, as in the
    reference, which computes it outside Pallas)."""
    return p[op.cells_p]


def scatter_p(op: NSOperator, y_e: torch.Tensor) -> torch.Tensor:
    """[E, dim + 1, *rest] -> [n_pnodes, *rest] (plain segmented sum)."""
    flat = y_e.reshape(op.plan_p.n_slots, -1)
    return _compress(op, apply_segment_plan(op.plan_p, flat)).view(op.plan_p.n_rows, *y_e.shape[2:])


def _compress(op: NSOperator, y: torch.Tensor) -> torch.Tensor:
    """A rank's partial node vector summed over the operator's group (a
    cell-sharded operator), else y as it is."""
    if op.group is not None:
        import torch.distributed as dist

        dist.all_reduce(y, group=op.group)
    return y


def apply_divergence(op: NSOperator, u: torch.Tensor) -> torch.Tensor:
    """y = D u: [n_unodes, dim, *rest] -> [n_pnodes, *rest] (assembled,
    or the element pass when `op.div` is None or u carries members, as the
    reference's vmapped step runs it)."""
    if op.div is None or u.dim() > 2:
        return apply_divergence_e(op, gather_u(op, u))
    return apply_csr(op.div, u)[:, 0]


def apply_gradient(op: NSOperator, p: torch.Tensor) -> torch.Tensor:
    """y = G p = -D^T p: [n_pnodes, *rest] -> [n_unodes, dim, *rest]
    (assembled, or the element pass when `op.grad` is None or p carries
    members)."""
    if op.grad is None or p.dim() > 1:
        return apply_gradient_e(op, p)
    return apply_csr(op.grad, p[:, None])


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with n trailing singleton axes (to broadcast over members)."""
    return x.reshape(x.shape + (1,) * n)


def apply_divergence_e(op: NSOperator, u_e: torch.Tensor) -> torch.Tensor:
    """y = D u from an element view u_e [E, n_loc_u, dim, *rest] ->
    [n_pnodes, *rest] (the reference's element divergence pass)."""
    y_e = torch.einsum("ekc,kij,ejc...->ei...", op.Jinv, op.BHAT, u_e)
    return scatter_p(op, y_e * _tail(op.detJ[:, None], u_e.dim() - 3))


def apply_gradient_e(op: NSOperator, p: torch.Tensor) -> torch.Tensor:
    """y = G p = -D^T p by the element pass: [n_pnodes, *rest] ->
    [n_unodes, dim, *rest] (its reduction is kernel C on the card)."""
    p_e = gather_p(op, p)
    y_e = torch.einsum("ekc,kij,ei...->ejc...", op.Jinv, op.BHAT, p_e)
    return scatter_u(op, -y_e * _tail(op.detJ[:, None, None], p.dim() - 1))


@dataclasses.dataclass
class BackflowTables:
    """Facet tables of the backflow stabilisation -rho/2 min(w.n, 0)(u, v)
    on an open boundary (the reference's dormant term,
    src/NavierStokes2D.cpp:456-483, live as in the reference package)."""

    cells_u: torch.Tensor  # [f, n_loc_u] int64
    phi_u: torch.Tensor  # [f, q, n_loc_u]
    jxw: torch.Tensor  # [f, q]
    normal: torch.Tensor  # [f, dim]
    plan: SegmentPlan  # [f * n_loc_u] facet slots -> [n_unodes]


def build_backflow_tables(space, bt, tag: int, dtype, device) -> BackflowTables:
    """Tables of the boundary facets tagged `tag` (`bt` from
    `fem.geometry.boundary_tables`)."""
    sel = np.where(bt.tag == tag)[0]
    cells = np.asarray(space.cells_u[bt.cell[sel]], np.int64)
    dev = lambda x: torch.as_tensor(np.asarray(x[sel]), dtype=dtype, device=device)  # noqa: E731
    return BackflowTables(
        cells_u=torch.as_tensor(cells, device=device),
        phi_u=dev(bt.phi_u), jxw=dev(bt.jxw), normal=dev(bt.normal),
        plan=build_segment_plan(cells, space.n_unodes, device=device),
    )


def _backflow_coef(bf: BackflowTables, w: torch.Tensor) -> torch.Tensor:
    """[f, q, *rest] facet coefficients -1/2 min(w.n, 0) JxW (>= 0) of
    w [n, dim, *rest]."""
    w_qf = torch.einsum("fqi,fic...->fqc...", bf.phi_u, w[bf.cells_u])
    un = torch.einsum("fqc...,fc->fq...", w_qf, bf.normal)
    return -0.5 * torch.clamp(un, max=0.0) * _tail(bf.jxw, un.dim() - 2)


def _backflow_apply(bf: BackflowTables, coef: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The facet term's action on u [n, C, *rest] -> [n, C, *rest] (coef
    [f, q, *rest])."""
    u_qf = torch.einsum("fqi,fic...->fqc...", bf.phi_u, u[bf.cells_u])
    y_f = torch.einsum("fq...,fqi,fqc...->fic...", coef, bf.phi_u, u_qf)
    f, i = y_f.shape[:2]
    return apply_segment_plan(bf.plan, y_f.reshape(f * i, -1)).view(bf.plan.n_rows, *y_f.shape[2:])


@dataclasses.dataclass
class ConvectionData:
    WG: torch.Tensor  # [E, q, nloc, *rest] (w . grad phi_i)(x_q)
    divw: torch.Tensor  # [E, q, *rest] div w (x_q)
    diagC: torch.Tensor | None  # global diag of C(w); None with with_diag=False
    # Folded per-element F_e = detJ/dt M^ + nu GKd:A^ + C_e(w) for the
    # (nu, dt) in `fold`: [E, nloc, nloc]; for a [B] tensor nu one matrix
    # set per member, held as F_e[j, e, i, b] ([nloc, E, nloc, B]).  With
    # conv_only, F_e is C_e(w) alone (the macro K/C split recombines the
    # constant part from setup-time blocks) and drives no element apply.
    F_e: torch.Tensor | None = None
    fold: tuple | None = None
    conv_only: bool = False
    # the backflow facet term's tables and [f, q] coefficients (None: none)
    bf: BackflowTables | None = None
    bf_coef: torch.Tensor | None = None


def _conv_quad(op: NSOperator, Jinv: torch.Tensor, w_e: torch.Tensor):
    """(w_q, WG, divw) of C(w) at the quadrature points from an element view
    w_e [E, nloc, dim, *rest] and its cells' Jinv."""
    w_q = torch.einsum("qi,eic...->eqc...", op.PHI_U, w_e)
    wtilde = torch.einsum("ekd,eqd...->eqk...", Jinv, w_q)
    WG = torch.einsum("qik,eqk...->eqi...", op.GRAD_U, wtilde)
    gref = torch.einsum("qik,eic...->eqkc...", op.GRAD_U, w_e)
    divw = torch.einsum("eqkc...,ekc->eq...", gref, Jinv)
    return w_q, WG, divw


def _conv_elem(op: NSOperator, R: torch.Tensor) -> torch.Tensor:
    """Unscaled element matrices sum_q W_q phi_i(x_q) R[e, q, j] [E, nloc, nloc]."""
    return torch.einsum("qi,eqj->eij", op.W[:, None] * op.PHI_U, R)


def convection_setup(
    op: NSOperator,
    w: torch.Tensor,
    fold: tuple | None = None,
    w_e: torch.Tensor | None = None,
    with_diag: bool = True,
    conv_only: bool = False,
    backflow: BackflowTables | None = None,
) -> ConvectionData:
    """Tabulate the linearised convection + Temam term of C(w) at the
    quadrature points and, with `fold=(nu, dt)`, fold the per-element F_e
    (with `conv_only`, C_e(w) alone).  Under IMEX (`op.imex_scale`) every
    C(w) term is weighted by the cell's implicit weight.

    `w` may carry trailing member axes ([n, dim, B]); nu in `fold` is then
    a [B] tensor.  `w_e` is a pre-gathered element view of w;
    `with_diag=False` skips diag(C) (the stepper's freeze_conv_diag mode).
    With `backflow` (a single run's), the facet term's coefficients are
    kept for the applies and its diagonal joins diag(C), which is then
    always built."""
    if w_e is None:
        w_e = gather_u(op, w)
    tail = w_e.dim() - 3
    _, WG, divw = _conv_quad(op, op.Jinv, w_e)
    diagC = bf_coef = None
    if not (with_diag or backflow is not None or fold is not None):
        # the unfolded step without diag(C): the tables alone (R, the size
        # of WG, is not built)
        return ConvectionData(WG=WG, divw=divw, diagC=None)
    R = WG + 0.5 * divw[:, :, None] * _tail(op.PHI_U[None], tail)
    cdet = op.detJ if op.imex_scale is None else op.detJ * op.imex_scale
    if with_diag or backflow is not None:
        # sum_q jxw (WG_i phi_i + 0.5 divw phi_i^2)
        d_e = torch.einsum("q,eqi...,qi->ei...", op.W, R, op.PHI_U)
        diagC = scatter_u(op, d_e * _tail(cdet[:, None], tail))
    if backflow is not None:
        bf_coef = _backflow_coef(backflow, w)
        d_f = torch.einsum("fq...,fqi,fqi->fi...", bf_coef, backflow.phi_u, backflow.phi_u)
        f, i = d_f.shape[:2]
        diagC = diagC + apply_segment_plan(backflow.plan, d_f.reshape(f * i, -1)).view(
            backflow.plan.n_rows, *d_f.shape[2:])
    F_e = None
    if fold is not None:
        nu, dt = fold
        base = op.stiff_e
        if torch.is_tensor(nu) and nu.dim() == 1:
            # members: [j, E, i, B], the layout `element_apply` streams
            F_e = (op.MHAT[None] * (op.detJ / dt)[:, None, None]).permute(2, 0, 1)[..., None]
            F_e = F_e + base.permute(2, 0, 1)[..., None] * nu
            WPHI = op.W[:, None] * op.PHI_U  # [q, i]
            C_e = torch.einsum("qi,eqjb->jeib", WPHI, R) * cdet[None, :, None, None]
            F_e = (F_e + C_e).contiguous()
        else:
            C_e = _conv_elem(op, R) * cdet[:, None, None]
            if conv_only:
                F_e = C_e
            else:
                F_e = op.MHAT[None] * (op.detJ / dt)[:, None, None] + nu * base
                F_e = F_e + C_e
    return ConvectionData(
        WG=WG, divw=divw, diagC=diagC, F_e=F_e, fold=fold,
        conv_only=conv_only and fold is not None,
        bf=backflow, bf_coef=bf_coef,
    )


def _check_fold(conv: ConvectionData, nu, dt) -> None:
    """Raise unless the folded `conv` holds the full F_e of this (nu, dt)."""
    if conv.conv_only:
        raise ValueError(
            "ConvectionData was folded conv_only (macro K/C split): its F_e "
            "is not the full velocity operator"
        )
    fnu, fdt = conv.fold
    if torch.is_tensor(nu) or torch.is_tensor(fnu):
        same_nu = nu is fnu or (
            torch.is_tensor(nu) and torch.is_tensor(fnu) and torch.equal(nu, fnu)
        )
    else:
        same_nu = abs(float(nu) - fnu) <= 1e-12 * max(1.0, abs(fnu))
    if not same_nu or abs(float(dt) - fdt) > 1e-12 * max(1.0, abs(fdt)):
        raise ValueError(
            f"folded ConvectionData was built for (nu={fnu}, dt={fdt}) but "
            f"applied with (nu={nu}, dt={dt})"
        )


def element_apply(F_e: torch.Tensor, x_e: torch.Tensor) -> torch.Tensor:
    """y[e, i, ...] = sum_j F_e[e, i, j] x_e[e, j, ...].

    With per-member matrices (F_e [j, E, i, B], x_e [E, j, c, B]) the
    product is kernel G on the card (`onehot.member_product`, reading x_e
    with its strides), its plain chain of multiply-adds on the CPU."""
    if F_e.dim() == 3:
        # one broadcast product and one sum over j: cuBLAS's batched GEMM
        # over 198,086 [10, 10] x [10, 3] products took 1.3443 ms on an
        # H100 (the IMEX fine subset at 965k), the gather and reduce
        # around it 0.03 and 0.11
        E, n = F_e.shape[:2]
        y = (F_e[:, :, :, None] * x_e.reshape(E, n, 1, -1).transpose(1, 2)).sum(2)
        return y.view(x_e.shape)
    return member_product(F_e, x_e)


def _apply_K_e(op: NSOperator, nu, dt, u_e: torch.Tensor) -> torch.Tensor:
    """Element contributions of K = M/dt + nu A (no convection) on an
    element view u_e [E, nloc, C, *rest] (nu a float, or [B] for members on
    the last axis)."""
    det = _tail((op.detJ / dt)[:, None, None], u_e.dim() - 3)
    y_e = torch.einsum("ij,ejc...->eic...", op.MHAT, u_e) * det
    return y_e + nu * element_apply(op.stiff_e, u_e)


def _apply_C_e(op: NSOperator, conv: ConvectionData, u_e: torch.Tensor) -> torch.Tensor:
    """Element contributions of C(w) on u_e [E, nloc, C, *rest], evaluated
    from the quadrature tables conv.WG and conv.divw (the unfolded path;
    weighted per cell under IMEX)."""
    tail = u_e.dim() - 3
    # r = (w.grad) u + 0.5 (div w) u at the quadrature points, summed over
    # the local nodes one node at a time in place (with members on trailing
    # axes an einsum would copy WG [E, q, nloc, *rest], the step's largest
    # table, into a batched layout every apply)
    r = torch.einsum("qi,eic...->eqc...", op.PHI_U, u_e).mul_(0.5 * conv.divw[:, :, None])
    for i in range(u_e.shape[1]):
        r.addcmul_(conv.WG[:, :, i, None], u_e[:, None, i])
    if op.imex_scale is not None:
        r.mul_(_tail(op.imex_scale[:, None, None], tail))
    return torch.einsum("q,qi,eqc...->eic...", op.W, op.PHI_U, r) * _tail(op.detJ[:, None, None], tail)


def _apply_F_e(op: NSOperator, nu, dt, conv: ConvectionData | None, u_e: torch.Tensor) -> torch.Tensor:
    """Element contributions of F on u_e: the folded F_e where `conv` holds
    one (checked against this (nu, dt)), else K plus C(w) from the tables
    (conv=None: K alone)."""
    if conv is not None and conv.F_e is not None:
        _check_fold(conv, nu, dt)
        return element_apply(conv.F_e, u_e)
    y_e = _apply_K_e(op, nu, dt, u_e)
    return y_e if conv is None else y_e + _apply_C_e(op, conv, u_e)


def apply_F(
    op: NSOperator, nu, dt, conv: ConvectionData | None, u: torch.Tensor,
    u_e: torch.Tensor | None = None,
) -> torch.Tensor:
    """F u through the folded element matrices, or unfolded when `conv`
    holds none (fold_elem=False), [n, dim, *rest] (the ensemble's velocity
    operator, a single run's element fallback, the block preconditioners'
    inner solves and the element reference the macro path is tested
    against); with conv=None the convection-free K = M/dt + nu A.  `u_e` is
    a pre-gathered element view of u; without it, per-member F_e go to
    kernel G with u's node rows (no element view of u is written).

    A bfloat16 `u` (the preconditioners' low_precision mode) moves
    bfloat16 values: its gather payload and the element contributions the
    reduce sums are rounded to bfloat16 (carried in the operator's dtype,
    which kernels C and D take), the products run in the operator's dtype,
    and the result is bfloat16."""
    lowp = u.dtype == torch.bfloat16
    if lowp:
        u = u.to(op.MHAT.dtype)  # exact: a bfloat16 value is representable
    if u_e is None and conv is not None and conv.F_e is not None and conv.F_e.dim() == 4:
        _check_fold(conv, nu, dt)
        y_e = member_product(conv.F_e, u, op.onehot)
    else:
        y_e = _apply_F_e(op, nu, dt, conv, gather_u(op, u) if u_e is None else u_e)
    if lowp:
        y = scatter_u(op, y_e.to(torch.bfloat16).to(y_e.dtype)).to(torch.bfloat16)
    else:
        y = scatter_u(op, y_e)
    if conv is not None and conv.bf_coef is not None:
        y = y + _backflow_apply(conv.bf, conv.bf_coef, u).to(y.dtype)
    return y


def apply_mass(op: NSOperator, u: torch.Tensor) -> torch.Tensor:
    """y = M u (velocity mass, unscaled): one element pass."""
    u_e = gather_u(op, u)
    y_e = torch.einsum("ij,ejc...->eic...", op.MHAT, u_e) * _tail(op.detJ[:, None, None], u_e.dim() - 3)
    return scatter_u(op, y_e)


def apply_stiffness(op: NSOperator, u: torch.Tensor) -> torch.Tensor:
    """y = A u (vector Laplacian, unscaled by nu): one element pass."""
    return scatter_u(op, element_apply(op.stiff_e, gather_u(op, u)))


def apply_pressure_mass(op: NSOperator, p: torch.Tensor) -> torch.Tensor:
    """y = Mp p (pressure mass, unscaled), p [n_pnodes, *rest]."""
    y_e = torch.einsum("ij,ej...->ei...", op.MPHAT, gather_p(op, p)) * _tail(op.detJ[:, None], p.dim() - 1)
    return scatter_p(op, y_e)


def apply_system(op: NSOperator, nu, dt, conv: ConvectionData, u, p, mask_rows: bool = True):
    """The saddle-point operator [[F, G], [D, 0]] on (u, p): F u + G p in one
    element pass and one velocity reduction (kernel C), D u from the same
    gather (kernel D), and identity rows on Dirichlet velocity nodes with
    `mask_rows` (the reference's row elimination)."""
    u_e = gather_u(op, u)
    p_e = gather_p(op, p)
    tail = u_e.dim() - 3  # members on trailing axes (u [n, dim, B], p [n_p, B])
    y_e = _apply_F_e(op, nu, dt, conv, u_e)
    det = _tail(op.detJ[:, None, None], tail)
    y_e = y_e - torch.einsum("ekc,kij,ei...->ejc...", op.Jinv, op.BHAT, p_e) * det
    y_u = scatter_u(op, y_e)
    if conv is not None and conv.bf_coef is not None:
        y_u = y_u + _backflow_apply(conv.bf, conv.bf_coef, u)
    y_pe = torch.einsum("ekc,kij,ejc...->ei...", op.Jinv, op.BHAT, u_e) * _tail(op.detJ[:, None], tail)
    y_p = scatter_p(op, y_pe)
    if mask_rows:
        y_u = torch.where(_tail(op.dirichlet_mask[:, None], tail), u, y_u)
    return y_u, y_p


def apply_rhs_and_r0(
    op: NSOperator, h: torch.Tensor, p: torch.Tensor, nu, dt,
    conv: ConvectionData | None, u0: torch.Tensor,
    h_e: torch.Tensor | None = None, u0_e: torch.Tensor | None = None,
    w_e: torch.Tensor | None = None,
):
    """(b, r0) = (M h - G p,  b - F u0) in one element pass and one
    dual-channel reduction (the reference's einsum branch; F folded or
    unfolded, or K alone with conv=None).  `h_e`/`u0_e` are pre-gathered
    element views of h/u0.  Under IMEX, `w_e` (the element view of w) fuses the explicit
    cells' rhs term -(1 - imex_scale) N(w) into b."""
    h_e = gather_u(op, h) if h_e is None else h_e
    u0_e = gather_u(op, u0) if u0_e is None else u0_e
    p_e = gather_p(op, p)
    det = _tail(op.detJ[:, None, None], h_e.dim() - 3)
    b_e = torch.einsum("ij,ejc...->eic...", op.MHAT, h_e) * det
    b_e = b_e + torch.einsum("ekc,kij,ei...->ejc...", op.Jinv, op.BHAT, p_e) * det
    f_e = _apply_F_e(op, nu, dt, conv, u0_e)
    if conv is not None and op.imex_scale is not None and w_e is not None:
        w_q = torch.einsum("qi,eic...->eqc...", op.PHI_U, w_e)
        nw = torch.einsum("eqi...,eic...->eqc...", conv.WG, w_e) + 0.5 * conv.divw[:, :, None] * w_q
        nw = nw * _tail((1.0 - op.imex_scale)[:, None, None], w_e.dim() - 3)
        b_e = b_e - torch.einsum("q,qi,eqc...->eic...", op.W, op.PHI_U, nw) * det
    y = scatter_u(op, torch.cat([b_e, b_e - f_e], dim=2))
    d = h.shape[1]
    b, r0 = y[:, :d], y[:, d:]
    if conv is not None and conv.bf_coef is not None:
        r0 = r0 - _backflow_apply(conv.bf, conv.bf_coef, u0)
    return b, r0


def apply_convection_self(
    op: NSOperator, w: torch.Tensor, w_e: torch.Tensor | None = None,
    backflow: BackflowTables | None = None,
) -> torch.Tensor:
    """N(w) = C(w) w in one element pass: ((w.grad)w, v) + 0.5((div w) w, v)
    at the quadrature points (the explicit-convection rhs; no fold, no
    diagonal).  `w_e` is a pre-gathered element view of w.  With
    `backflow`, the facet term -rho/2 min(w.n, 0)(w, v) is added."""
    if w_e is None:
        w_e = gather_u(op, w)
    w_q, WG, divw = _conv_quad(op, op.Jinv, w_e)
    r = torch.einsum("eqi...,eic...->eqc...", WG, w_e) + 0.5 * divw[:, :, None] * w_q
    y_e = torch.einsum("q,qi,eqc...->eic...", op.W, op.PHI_U, r) * _tail(op.detJ[:, None, None], w_e.dim() - 3)
    y = scatter_u(op, y_e)
    if backflow is not None:
        y = y + _backflow_apply(backflow, _backflow_coef(backflow, w), w)
    return y


@dataclasses.dataclass
class ImexTables:
    """The IMEX fine (implicit-convection) cell subset.  With K applied as
    an assembled operator, only these cells pay a per-iteration element
    pass: F u = K u + C_fine(w) u.  Its gather and reduce are kernels D and
    C on a slot plan of the subset's cells."""

    f_idx: torch.Tensor  # [E_f] int64 cell ids
    Jinv_f: torch.Tensor  # [E_f, dim, dim]
    detJ_f: torch.Tensor  # [E_f]
    plans: OneHotPlans  # [E_f * nloc] slots <-> [n_unodes] rows


def build_imex_tables(space, geom, implicit_cells, dtype, device) -> ImexTables:
    """Tables of the implicit-convection subset (cell ids `implicit_cells`)."""
    f = np.asarray(implicit_cells, dtype=np.int64)
    return ImexTables(
        f_idx=torch.as_tensor(f, device=device),
        Jinv_f=torch.as_tensor(geom.Jinv[f], dtype=dtype, device=device),
        detJ_f=torch.as_tensor(geom.detJ[f], dtype=dtype, device=device),
        plans=build_onehot_plans(np.asarray(space.cells_u)[f], space.n_unodes, device=device),
    )


def convection_fine_fold(op: NSOperator, imex: ImexTables, w_ef: torch.Tensor) -> torch.Tensor:
    """C_e(w) [E_f, nloc, nloc] on the fine subset (unweighted: fine cells
    carry imex_scale 1) from its element view of w, w_ef [E_f, nloc, dim]."""
    _, WG, divw = _conv_quad(op, imex.Jinv_f, w_ef)
    R = WG + 0.5 * divw[:, :, None] * op.PHI_U[None]
    return _conv_elem(op, R) * imex.detJ_f[:, None, None]


def apply_convection_fine(imex: ImexTables, C_ef: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """C_fine(w) u, [n, C] -> [n, C]: subset gather (kernel D), the subset's
    element product, subset reduce (kernel C)."""
    n_f, C = C_ef.shape[0], u.shape[1]
    u_ef = onehot_gather(imex.plans, u.contiguous()).view(n_f, -1, C)
    return onehot_reduce(imex.plans, element_apply(C_ef, u_ef).reshape(-1, C))


def diag_F(op: NSOperator, nu, dt, conv: ConvectionData | None) -> torch.Tensor:
    """diag(F): [n_unodes], or [n_unodes, B] for a [B] tensor nu."""
    if torch.is_tensor(nu) and nu.dim() == 1:
        d = op.diagM[:, None] / dt + nu * op.diagA[:, None]
    else:
        d = op.diagM / dt + nu * op.diagA
    if conv is not None and conv.diagC is not None:
        d = d + conv.diagC
    return d
