"""Time-stepping Navier-Stokes solver (PyTorch): setup, the two steppers,
and the chunked run.

The counterpart of the reference's `models/base.py`: its two steppers
under BDF1 or BDF2 (BDF1 on the first step, then the three-level history
with extrapolated convection; explicit convection then takes the
Adams-Bashforth-2 rhs through `State.conv_prev`), in 2D and 3D, with the
problems' Neumann face, forcing, initial state and backflow term.  The
monolithic saddle-point stepper (`_step_monolithic`, the
reference's `_step_dispatch`, the default of its CLI) solves the packed
[3 n_u + n_p] system by flexible GMRES in increment form, preconditioned
by a block preconditioner of `precond/blocks.py` (all seven kinds).  The
incremental pressure-correction (projection) stepper solves the pressure
Poisson over the frozen S1 (banded, or its ELL SpMV when the band is too
wide or "ell" is asked for) or the step's assembled S~ (proj_schur
"step"), with a two-level preconditioner (additive or V(1,1); Cholesky or
inverse coarse solve), by recycled-projection CG (precond.s_recycle >= 1)
or plain CG; the velocity by FGMRES preconditioned by Jacobi or, with
f_iters > 0, the block preconditioners' fixed inner solve, by
recycled-block GCR (f_recycle) or, with explicit convection, CG.  A
configuration outside these is rejected with ValueError (`check_config`).

`run` advances in chunks of numerics.steps_per_chunk steps and calls its
callback after each (the CLI's CSV, VTU and checkpoint writer).

One single-run step (`step`, the reference's `_step_projection`):

  1. Dirichlet data and the warm start u0; one gather of the step's node
     fields: the slot gather of [hist | u0 | warm-start pool | w] on the
     macro path (w's element view from its slots), else one element gather
     of [hist | u0 | w] (kernel D on the card);
  2. convection: implicit folds F_e = M/dt + nu A + C(w) per element
     (`convection_setup`; C_e(w) alone under the macro K/C split; with
     numerics.fold_elem=False only C(w)'s quadrature tables, which every
     element apply then evaluates) and the macro path builds the block
     values FtT (kernel B); IMEX weights C(w) per cell and folds the fine
     subset's C_e; explicit evaluates N(u) = C(u)u for the rhs;
  3. b = M hist - G p_n and r0 = b - F u0: on the macro path from the slot
     view (kernel A; the warm-start pool's images F D ride the same
     launch), else in one element pass (IMEX fuses -(1 - s)N(w) into b);
  4. the velocity solve F du = r0 on the operator of the path: macro
     blocks (kernel A), the element fold (kernels D and C), or the
     assembled constant K (`ops/bsr.py`) plus the IMEX fine subset
     (kernels D and C on its own plan); u* = u0 + du;
  5. S1 phi = -D u* / dt with CG (on the frozen S1 on the card, with no
     process group, each iteration a replay of the CUDA graphs captured at
     the first solve, `solvers/krylov.py CGGraphs`); p = p_n + phi;
     u = u* - dt diag(M)^-1 G phi on free nodes;
  6. drag, lift and the pressure difference.

One ensemble step (`step(state, nu)` with nu a [B] tensor: the same two
steppers, as the reference's vmapped `run_ensemble` runs them) advances B
members at once, each with its own nu, carried on a trailing member axis
of every state array and pool.  It takes every configuration a single run
takes, on the paths the reference keeps under vmap: the element fold for
every velocity apply (no macro blocks, no assembled K or IMEX fine subset,
element D and G, no aux divergence), the F bound of the smoothers by a
per-member power iteration, and the velocity warm-start pool carried
unused (the reference projects it only on the macro path).  The element
passes move all members as packed channels through the slot gather and
reduce (kernels D and C), and the Krylov solves are batched on [n, B]
columns with per-member tolerances and counts.

Spans (`utils/profiling.py`) name the set-up phases (`setup.reorder`,
`setup.space`, `setup.operator`, `setup.boundary`, `setup.f_bound`,
`setup.frozen_schur`, `setup.coarse_factor`, and `setup.macro`,
`setup.macro_mass`, `setup.macro_stiff` built at first use, and
`setup.krylov_graphs`, the pressure CG's capture), each phase
of a projection step, single run and ensemble alike (`step.guess`,
`step.gather`, `step.fold`, `step.build`, `step.rhs`, `step.f_solve`,
`step.divergence`, `step.s_solve`, `step.update`, `step.diagnostics`),
each read of a value to the host (`host_read`) and the copy of a chunk's
diagnostics to the host (`run.host_copy`) in a running torch.profiler
trace.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from collections.abc import Mapping
from typing import Callable, Optional

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.config import RunConfig
from navierstokes_project_nm4pde_tpu_torch.device import pick_device, torch_dtype
from navierstokes_project_nm4pde_tpu_torch.fem.geometry import (
    boundary_tables,
    cell_geometry,
)
from navierstokes_project_nm4pde_tpu_torch.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu_torch.ops import functionals as fn
from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
from navierstokes_project_nm4pde_tpu_torch.ops.banded import (
    BandedSchur,
    banded_matvec,
    build_banded_schur,
)
from navierstokes_project_nm4pde_tpu_torch.ops.bsr import (
    CSRMatrix,
    apply_csr_scalar,
    build_velocity_kcsr,
)
from navierstokes_project_nm4pde_tpu_torch.ops.coarse import (
    cho_solve_c,
    cho_w_solve_c,
    frozen_cho_w,
    host_coarse_dense,
    inv_solve_c,
    twolevel_apply_additive_g,
    twolevel_apply_g,
)
from navierstokes_project_nm4pde_tpu_torch.ops.pmg import build_velocity_pmg
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    SegmentPlan,
    apply_inverse_map,
    apply_segment_plan,
    build_inverse_map,
    build_segment_plan,
)
from navierstokes_project_nm4pde_tpu_torch.ops.schur_ell import (
    schur_ell_matvec,
    schur_from_host,
)
from navierstokes_project_nm4pde_tpu_torch.ops.spai import build_spai_values
from navierstokes_project_nm4pde_tpu_torch.ops.tables import build_ref_tables
from navierstokes_project_nm4pde_tpu_torch.precond.blocks import (
    F_SOLVERS,
    PRECOND_KINDS,
    S_SOLVERS,
    _solve_F,
    apply_precond,
    build_precond_state,
    f_lam_power,
    inv_diag_Fhat,
)
from navierstokes_project_nm4pde_tpu_torch.solvers.krylov import (
    CGGraphs,
    _cnorm,
    _host,
    _host_float,
    _norm,
    cg,
    cg_recycled,
    fgmres,
    gcr_recycled,
    ls_warmstart,
)
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import setup_phase, span


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Physics and boundary data of one problem; callables take torch
    tensors and a float time."""

    dim: int
    nu: float
    rho: float = 1.0
    # Dirichlet: tag -> g(x[n, dim], t) -> [n, dim]
    dirichlet: dict = dataclasses.field(default_factory=dict)
    # Neumann: tag -> h(x[..., dim], t) -> [..., dim]; None = no Neumann face
    neumann_tag: Optional[int] = None
    neumann_value: Optional[Callable] = None
    forcing: Optional[Callable] = None  # f(x[..., dim], t) -> [..., dim]
    u0: Optional[Callable] = None  # u0(x[n, dim]) -> [n, dim]
    p0: Optional[Callable] = None  # p0(x[n, dim]) -> [n]
    # backflow stabilisation on this open boundary (the reference's dormant
    # term, src/NavierStokes2D.cpp:456-483, live)
    backflow_tag: Optional[int] = None
    obstacle_tag: Optional[int] = None
    probe_points: Optional[tuple] = None
    mean_velocity: Optional[Callable] = None  # U_ref(t) -> float
    diameter: float = 0.1
    span: Optional[float] = None


@dataclasses.dataclass
class State:
    """Solver state.  There are no weights: this is what a run carries.
    An ensemble's state carries its B members on a trailing axis of every
    array (u [n_unodes, dim, B], p [n_pnodes, B]); all members share t and
    step."""

    u: torch.Tensor  # [n_unodes, dim]
    p: torch.Tensor  # [n_pnodes]
    t: float
    step: int
    u_prev: torch.Tensor | None = None  # u^{n-1} (BDF2 / warm-start extrapolation)
    p_prev: torch.Tensor | None = None  # p^{n-1}
    u_prev2: torch.Tensor | None = None  # u^{n-2} (guess_order=2)
    # N(u^{n-1}) = C(u^{n-1}) u^{n-1}: explicit convection under BDF2 takes
    # the Adams-Bashforth-2 rhs 2 N(u^n) - N(u^{n-1}) (N is quadratic, so
    # C(w)w at the extrapolated w is not second order)
    conv_prev: torch.Tensor | None = None
    # [2, k, n_p]: recycled pressure directions and their exact S1 images
    # (precond.s_recycle = k >= 1; None with plain CG)
    spool: torch.Tensor | None = None
    # [k, n_unodes * dim]: the velocity GCR's recycled directions
    # (precond.f_recycle = k >= 1); zeros are always valid
    fpool: torch.Tensor | None = None
    # [k, n_unodes * dim]: the last k velocity increments, whose images
    # under each step's F ride its rhs pass (precond.f_warmstart = k >= 1);
    # zeros are always valid
    fwpool: torch.Tensor | None = None


_STATE_ARRAYS = ("u", "p", "u_prev", "p_prev", "u_prev2", "conv_prev", "spool", "fpool", "fwpool")


def state_to_numpy(state: State) -> dict:
    """State -> dict of numpy arrays (None where absent) + t and step."""
    out = {
        k: (None if getattr(state, k) is None else getattr(state, k).cpu().numpy())
        for k in _STATE_ARRAYS
    }
    out["t"] = float(state.t)
    out["step"] = int(state.step)
    return out


def state_from_numpy(arrays, device, dtype: torch.dtype | None = None) -> State:
    """State from numpy arrays: a mapping, or any object with the same
    attribute names (e.g. the reference package's State after np.asarray
    of its fields).  Both packages can then continue the same run."""
    get = arrays.get if isinstance(arrays, Mapping) else (
        lambda k: getattr(arrays, k, None)
    )
    dev = torch.device(device)

    def conv(k):
        v = get(k)
        if v is None:
            return None
        v = np.array(v)  # a writable copy (jax hands out read-only views)
        return torch.as_tensor(v, dtype=dtype or torch_dtype(str(v.dtype)), device=dev)

    return State(
        t=float(np.asarray(get("t"))), step=int(np.asarray(get("step"))),
        **{k: conv(k) for k in _STATE_ARRAYS},
    )


@dataclasses.dataclass
class StepDiagnostics:
    iters: np.ndarray  # F + S iterations per step
    residual: np.ndarray
    drag: np.ndarray
    lift: np.ndarray
    c_d: np.ndarray
    c_l: np.ndarray
    delta_p: np.ndarray
    iters_f: np.ndarray
    iters_s: np.ndarray
    graphed_s: np.ndarray  # the S iterations replayed as CUDA graphs (a sweep's lockstep count)


@dataclasses.dataclass
class NeumannTables:
    """The Neumann face's facet quadrature (from `boundary_tables`)."""

    phi_u: torch.Tensor  # [f, q, n_loc_u]
    jxw: torch.Tensor  # [f, q]
    points: torch.Tensor  # [f, q, dim] physical quadrature points
    plan: SegmentPlan  # [f * n_loc_u] facet slots -> [n_unodes]


@dataclasses.dataclass
class FrozenSchur:
    """Setup-time data of the pressure Poisson S1 phi = rhs / dt."""

    inv1: torch.Tensor  # [n_unodes] 1/diagM on free nodes, 0 constrained
    diag1: torch.Tensor  # [n_p] diagonal of S1
    inv_d: torch.Tensor  # [n_p] 1 / diag1, the preconditioner's Jacobi part
    cho_w: torch.Tensor | None  # [nc, ld] W = L^-1 of the coarse matrix's factor, W^T above (`frozen_cho_w`)
    inv_c: torch.Tensor | None  # dense inverse of the coarse matrix (coarse_solve="inv")
    band: BandedSchur | None  # None: the ELL SpMV over vals1 (op.schur's layout)
    vals1: torch.Tensor | None = None  # [n_slots] S1's ELL values (without a band)


# Values that only chose a TPU layout or engine; every one of them is the
# same operator here.
_LAYOUT_ONLY = {
    "macro_build": ("auto", "highest", "split3"),
    "macro_apply": ("auto", "highest", "split3"),
    "macro_conv_build": ("auto", "default", "highest", "split3"),
    # the reference's one-hot ensemble reductions accumulate in f32 (its
    # MXU path); here every ensemble reduction is the exact kernel C
    "ensemble_onehot": (False, True),
}

# The variants both steps run (the single run and the ensemble).
_VARIANTS = {
    "time.stepper": ("projection", "monolithic"),
    "time.convection": ("implicit", "explicit", "imex"),
    "precond.kind": PRECOND_KINDS,
    "precond.f_solver": F_SOLVERS,
    "precond.s_solver": S_SOLVERS,
    "precond.mg2_form": ("additive", "v11"),
    "numerics.proj_schur": ("frozen", "step"),
    "numerics.schur_spmv": ("auto", "banded", "ell"),
    "numerics.coarse_solve": ("chol", "inv"),
    "numerics.vel_apply": ("auto", "bsr", "element"),
    "numerics.f_apply": ("auto", "macro", "element"),
    "numerics.macro_rhs": ("auto", "on", "off"),
    "numerics.macro_wfuse": ("auto", "on", "off"),
    "numerics.macro_split": ("auto", "off", "on"),
    # "ell" is the reference's assembled-transpose G: the same assembled
    # operator as "bsr" here (ops/bsr.py)
    "numerics.grad_apply": ("auto", "bsr", "ell", "element"),
    "numerics.div_apply": ("auto", "bsr", "element"),
}


def _field(cfg: RunConfig, name: str):
    part, key = name.split(".")
    return getattr(getattr(cfg, part), key)


def check_config(cfg: RunConfig, problem: ProblemSpec) -> None:
    """Raise ValueError, naming the field, for a configuration this port
    does not run (yet), or that the reference refuses."""
    req = [
        ("time.scheme", cfg.time.scheme, ("bdf1", "bdf2")),
        ("numerics.dtype", cfg.numerics.dtype, ("float32", "float64")),
        ("solver.tol_mode", cfg.solver.tol_mode, ("r0", "b", "abs")),
        ("solver.guess_order", cfg.solver.guess_order, (1, 2)),
        ("problem.dim", problem.dim, (2, 3)),
    ]
    req += [(name, _field(cfg, name), ok) for name, ok in _VARIANTS.items()]
    req += [
        (f"numerics.{k}", getattr(cfg.numerics, k), ok)
        for k, ok in _LAYOUT_ONLY.items()
    ]
    for name, val, ok in req:
        if val not in ok:
            raise ValueError(
                f"the PyTorch port does not run {name}={val!r} yet "
                f"(supported: {ok})"
            )
    if cfg.precond.s_recycle < 0 or cfg.precond.f_iters < 0:
        raise ValueError("precond.s_recycle and precond.f_iters must be >= 0")
    monolithic = cfg.time.stepper == "monolithic"
    if monolithic and cfg.time.convection != "implicit":
        raise ValueError(
            f"convection={cfg.time.convection!r} requires the projection stepper "
            "(the monolithic saddle-point path keeps linearised-implicit convection)"
        )
    if cfg.time.convection == "imex" and cfg.time.imex_umax is None:
        raise ValueError(
            "convection='imex' requires TimeConfig.imex_umax (the CFL "
            "velocity scale of the per-cell explicit/implicit partition)"
        )
    if cfg.numerics.vel_apply == "bsr" and not _constant_k(cfg):
        raise ValueError(
            "vel_apply='bsr' requires the projection stepper with convection "
            "'explicit' or 'imex' and scheme 'bdf1' (the velocity block must "
            "be constant)"
        )
    if cfg.numerics.f_apply == "macro" and not _macro_ok(cfg, problem):
        raise ValueError(
            "f_apply='macro' requires the projection stepper with implicit "
            "convection, fold_elem and spatial_reorder, and no backflow term "
            "(the block values hold the volume terms of the folded F only, on "
            "blocks of consecutive cells)"
        )


def _macro_ok(cfg: RunConfig, problem: ProblemSpec) -> bool:
    """The macro-block F can run: the projection stepper with implicit
    convection, the fold (its blocks are built from F_e), the spatial
    reorder (a block's consecutive cells share few nodes) and no backflow
    facet term (the blocks hold the volume terms only)."""
    return (
        cfg.time.stepper == "projection" and cfg.time.convection == "implicit"
        and cfg.numerics.fold_elem and cfg.numerics.spatial_reorder
        and problem.backflow_tag is None
    )


def _constant_k(cfg: RunConfig) -> bool:
    """The velocity block is constant across steps (K = M/dt + nu A, the
    assembled operator's case): projection, explicit or IMEX convection,
    BDF1."""
    return (
        cfg.time.stepper == "projection"
        and cfg.time.convection in ("explicit", "imex")
        and cfg.time.scheme == "bdf1"
    )


class NavierStokesSolver:
    """Solver for one `ProblemSpec` on one mesh (the port's own
    `mesh.Mesh`), on `device`: None means the card, and raises without
    one; "cpu" runs the kernels' plain versions.

    Set-up resolves the configuration's paths (the reference's rules): the
    node order (RCM for the banded frozen Schur or the one-hot ensemble,
    else Morton; the input mesh's own with spatial_reorder=False), `kcsr`
    the assembled constant K (vel_apply "bsr", the default with explicit or
    IMEX convection), `imex` the IMEX fine subset, `f_apply` "macro" (the
    projection stepper with implicit convection, the fold, the reorder and
    no K) or "element", the macro rhs pass, its fused
    gather and the K/C split (macro_rhs, macro_wfuse, macro_split), and
    only the Schur data the stepper reads: the frozen S1 (projection), or
    S~'s per-step assembly tables (monolithic, proj_schur "step")."""

    def __init__(self, mesh, problem: ProblemSpec, config: RunConfig, device=None):
        check_config(config, problem)
        if problem.dim != mesh.dim:
            raise ValueError(f"problem.dim={problem.dim} on a {mesh.dim}D mesh")
        self.problem = problem
        self.config = config
        self.device = pick_device(device)
        self.dtype = torch_dtype(config.numerics.dtype)
        self._cg_graphs = CGGraphs()
        self._setup(mesh)

    # ------------------------------------------------------------------
    def _setup(self, mesh):
        cfg, dev, dt_ = self.config, self.device, self.dtype
        nc, pc, conv_mode = cfg.numerics, cfg.precond, cfg.time.convection
        monolithic = cfg.time.stepper == "monolithic"
        frozen = not monolithic and nc.proj_schur == "frozen"
        # The reference's rule: RCM where the banded frozen Schur (or the
        # ensemble's one-hot windows) wants bounded index windows, Morton
        # otherwise; spatial_reorder=False keeps the input mesh's order
        # (the frozen Schur's band is then taken on it, or its ELL fallback
        # where the band is too wide).
        wants_banded = frozen and nc.schur_spmv in ("auto", "banded")
        with setup_phase("setup.reorder"):
            self.mesh = mesh
            if nc.spatial_reorder:
                self.mesh = mesh.reorder_spatial("rcm" if nc.ensemble_onehot or wants_banded else "morton")
        with setup_phase("setup.space"):
            self.space = build_taylor_hood(self.mesh)
            self.geom = cell_geometry(self.space)
            space = self.space
            dtags = sorted(self.problem.dirichlet.keys())
            mask = space.dirichlet_mask(dtags)
        # the frozen S1 is assembled once on the host; the monolithic
        # stepper's block preconditioners and proj_schur="step" assemble S~
        # every step on the device
        with setup_phase("setup.operator"):
            self.op, host = ops.build_operator(
                space, self.geom, mask, dt_, dev, coarse_agg=nc.schur_agg,
                device_schur_assembly=not frozen,
            )
            default_assembled = "element" if monolithic else "bsr"
            if (default_assembled if nc.grad_apply == "auto" else nc.grad_apply) == "element":
                self.op.grad = None
            if (default_assembled if nc.div_apply == "auto" else nc.div_apply) == "element":
                self.op.div = None

            # IMEX partition: a cell keeps its implicit C(w) iff
            # u_max dt / h_cell > imex_cfl, h_cell its shortest edge.
            self.imex = self.imex_frac = None
            if conv_mode == "imex":
                cc = self.mesh.coords[self.mesh.cells]  # [E, nvloc, dim]
                h = None
                for i in range(cc.shape[1]):
                    for j in range(i + 1, cc.shape[1]):
                        e = np.linalg.norm(cc[:, i] - cc[:, j], axis=1)
                        h = e if h is None else np.minimum(h, e)
                implicit = cfg.time.imex_umax * cfg.time.dt / np.maximum(h, 1e-300) > cfg.time.imex_cfl
                self.imex_frac = float(implicit.mean())
                self.op.imex_scale = torch.as_tensor(implicit.astype(np.float64), dtype=dt_, device=dev)
                if implicit.any():
                    self.imex = ops.build_imex_tables(
                        space, self.geom, np.nonzero(implicit)[0], dt_, dev
                    )

            # The constant K = M/dt + nu A as one assembled operator, where the
            # velocity block is constant (explicit or IMEX convection, BDF1).
            va = nc.vel_apply
            if va == "auto":
                va = "bsr" if _constant_k(cfg) else "element"
            self.kcsr: CSRMatrix | None = None
            if va == "bsr":
                self.kcsr = build_velocity_kcsr(
                    space, self.geom, build_ref_tables(space.dim), self.problem.nu,
                    cfg.time.dt, dt_, dev,
                )
            fa = nc.f_apply
            if fa == "auto":
                fa = "macro" if _macro_ok(cfg, self.problem) else "element"
            self.f_apply = fa
            self.macro_rhs = fa == "macro" and nc.macro_rhs != "off"
            self.macro_wfuse = self.macro_rhs and nc.macro_wfuse != "off"
            # the smoothers apply F through the element fold, which a
            # convection-only fold cannot drive: f_iters > 0 turns the split off
            self.macro_split = self.macro_rhs and nc.macro_split == "on" and pc.f_iters == 0
            # the element FGMRES collects its applies' gathers into du_e, from
            # which the element divergence needs no gather of its own
            self.aux_div = fa == "element" and self.kcsr is None and self.op.div is None

            # what the inner velocity solves read: the monolithic stepper's
            # preconditioners always, the projection stepper's with f_iters > 0
            inner_f = monolithic or pc.f_iters > 0
            if pc.f_solver == "pmg" and inner_f:
                self.op.pmg = build_velocity_pmg(space, self.geom, np.asarray(mask), dt_, dev)
            if monolithic and pc.s_solver.startswith("spai"):
                self.op.spai_vals = torch.as_tensor(
                    build_spai_values(self.op, host, self.problem.nu, cfg.time.dt), dtype=dt_, device=dev,
                )

        with setup_phase("setup.boundary"):
            # Dirichlet node groups; later tags win at shared nodes.
            taken = np.zeros(space.n_unodes, dtype=bool)
            self._bc_groups = []
            node_groups = []
            for tag in reversed(dtags):
                nodes = space.boundary_unodes([tag])
                nodes = nodes[~taken[nodes]]
                taken[nodes] = True
                node_groups.append(nodes)
                self._bc_groups.append((
                    self.problem.dirichlet[tag],
                    torch.as_tensor(space.unode_coords[nodes], dtype=dt_, device=dev),
                ))
            self._bc_inverse = build_inverse_map(node_groups, space.n_unodes, device=dev)

            bt = boundary_tables(space, self.geom, degree=4)
            pb = self.problem
            # the Neumann face's tables: int_Gamma h . v ds, reduced into the
            # velocity rows by a segment plan of its facet slots
            self.neumann = None
            if pb.neumann_tag is not None:
                sel = np.where(bt.tag == pb.neumann_tag)[0]
                cells = np.asarray(space.cells_u[bt.cell[sel]], np.int64)
                self.neumann = NeumannTables(
                    phi_u=torch.as_tensor(bt.phi_u[sel], dtype=dt_, device=dev),
                    jxw=torch.as_tensor(bt.jxw[sel], dtype=dt_, device=dev),
                    points=torch.as_tensor(bt.points[sel], dtype=dt_, device=dev),
                    plan=build_segment_plan(cells, space.n_unodes, device=dev),
                )
            self.backflow = None
            if pb.backflow_tag is not None:
                self.backflow = ops.build_backflow_tables(space, bt, pb.backflow_tag, dt_, dev)
            # the forcing's cell quadrature (degree 4)
            self.ftab = None
            if pb.forcing is not None:
                self.ftab = fn.build_error_tables(space, self.geom, degree=4, dtype=dt_, device=dev)
            self.forces = None
            if self.problem.obstacle_tag is not None:
                self.forces = fn.build_force_tables(
                    space, bt, self.problem.obstacle_tag, dt_, dev
                )
            self.probe = None
            if self.problem.probe_points is not None:
                self.probe = fn.build_point_probe(
                    space, self.geom, self.problem.probe_points, dt_, dev
                )

        # A set-up bound on lam_max(diag(F)^-1 F) of the convection-free F,
        # for the damped smoothers: 8 power iterations.
        # BDF2's warm steps solve with dt_eff = dt / 1.5 (more mass-dominated:
        # a larger Jacobi-scaled lam_max), so the bound is taken there.
        with setup_phase("setup.f_bound"):
            self._f_lam0 = None
            if pc.f_solver in ("richardson", "chebyshev", "pmg") and inner_f:
                nu, dt = self.problem.nu, cfg.time.dt
                if cfg.time.scheme == "bdf2":
                    dt = dt / 1.5
                self._f_lam0 = f_lam_power(self.op, nu, dt, None, inv_diag_Fhat(self.op, nu, dt, None), iters=8)

        # Frozen Schur S1 = D diag(M)^-1 D^T, its coarse factor's inverse
        # (or the coarse matrix's) and banded form (or its ELL values, when
        # the band is too wide or "ell" is asked for), once on the host in
        # float64.
        self.proj_schur = None
        if frozen:
            with setup_phase("setup.frozen_schur"):
                mask_np = np.asarray(mask, dtype=bool)
                inv1 = np.where(mask_np, 0.0, 1.0 / host["diagM"])
                vals1 = host["vals1"]
                diag1 = vals1[host["diag_slot"]]
                diag1 = np.where(diag1 > 0, diag1, 1.0)
                cs = self.op.coarse
                Sc = host_coarse_dense(host, vals1, cs.nc, cs.agg)
                band = None
                if nc.schur_spmv in ("auto", "banded"):
                    smask = host["smask"]
                    band = build_banded_schur(
                        host["srow"][smask], host["scol"][smask], vals1[smask],
                        n_rows=len(diag1), dtype=dt_, device=dev,
                    )
                    if band is None and nc.schur_spmv == "banded":
                        raise ValueError(
                            "schur_spmv='banded': the RCM band is too wide for the "
                            "dense form; use 'auto' or 'ell'"
                        )
                if band is None:  # the ELL SpMV over S1's values
                    self.op.schur = schur_from_host(host, dt_, dev)
            with setup_phase("setup.coarse_factor"):
                inv = nc.coarse_solve == "inv"
                diag1 = torch.as_tensor(diag1, dtype=dt_, device=dev)
                self.proj_schur = FrozenSchur(
                    inv1=torch.as_tensor(inv1, dtype=dt_, device=dev),
                    diag1=diag1,
                    inv_d=1.0 / diag1,
                    cho_w=None if inv else frozen_cho_w(Sc, dt_, dev),
                    inv_c=torch.as_tensor(np.linalg.inv(Sc), dtype=dt_, device=dev) if inv else None,
                    band=band,
                    vals1=None if band is not None else torch.as_tensor(vals1, dtype=dt_, device=dev),
                )

    @functools.cached_property
    def macro(self) -> mb.MacroPlan:
        """The single run's macro-block plan, built at first use (the
        ensemble step never reads it)."""
        nc = self.config.numerics
        with setup_phase("setup.macro"):
            return mb.build_macro_plan(
                self.space.cells_u, self.space.n_unodes, U=nc.macro_u,
                c_blk=nc.macro_cblk, device=self.device,
            )

    @functools.cached_property
    def macro_mass(self) -> torch.Tensor:
        """The mass matrix's macro blocks (single run; at first use)."""
        with setup_phase("setup.macro_mass"):
            return mb.build_macro_mass(self.macro, self.op.MHAT, self.op.detJ)

    @functools.cached_property
    def macro_stiff(self) -> torch.Tensor:
        """The stiffness matrix's macro blocks, for the K/C split (kernel B
        on GKd:AHAT; single run, at first use)."""
        with setup_phase("setup.macro_stiff"):
            return mb.build_macro_values(self.macro, self.op.stiff_e)

    # ------------------------------------------------------------------
    def initial_state(self, members: int | None = None) -> State:
        """The problem's initial state (u0, p0 at the reordered mesh's
        nodes; at rest where it gives none); with `members`, an ensemble
        state of that many members (trailing member axis on every array,
        the recycle pools' too)."""
        n, d = self.space.n_unodes, self.space.dim
        pb, cfg = self.problem, self.config
        T = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)  # noqa: E731
        if pb.u0 is not None:
            u = pb.u0(T(self.space.unode_coords)).to(self.dtype)
        else:
            u = torch.zeros((n, d), dtype=self.dtype, device=self.device)
        if pb.p0 is not None:
            p = pb.p0(T(self.mesh.coords)).to(self.dtype)
        else:
            p = torch.zeros(self.space.n_pnodes, dtype=self.dtype, device=self.device)
        if members is not None:
            u = u[..., None].repeat(1, 1, members)
            p = p[..., None].repeat(1, members)
        ext = cfg.solver.extrapolate_guess
        keep_hist = cfg.time.scheme == "bdf2" or ext
        quad = ext and cfg.solver.guess_order >= 2
        explicit_bdf2 = cfg.time.convection == "explicit" and cfg.time.scheme == "bdf2"
        return State(
            u=u, p=p, t=0.0, step=0,
            u_prev=u if keep_hist else None,
            p_prev=p if ext else None,
            u_prev2=u if quad else None,
            # a placeholder: step 0 takes AB1 and overwrites it
            conv_prev=torch.zeros_like(u) if explicit_bdf2 else None,
            **{k: self._zero_pool(k, members) for k in self._pool_shapes()},
        )

    def _pool_shapes(self) -> dict:
        """The single run's recycle pools and their shapes (0 rows: none)."""
        pc, nd = self.config.precond, self.space.n_unodes * self.space.dim
        return {
            "spool": (2, pc.s_recycle, self.space.n_pnodes),
            "fpool": (pc.f_recycle, nd),
            "fwpool": (pc.f_warmstart, nd),
        }

    def _zero_pool(self, name: str, members: int | None = None) -> torch.Tensor | None:
        shape = self._pool_shapes()[name]
        if 0 in shape or self.config.time.stepper != "projection":
            return None
        return torch.zeros(shape + ((members,) if members else ()), dtype=self.dtype, device=self.device)

    def _ensure_pools(self, state: State) -> State:
        """Give an externally supplied state (a single run's, or an
        ensemble's) the recycle pools it lacks (a zero pool is always
        valid)."""
        members = state.p.shape[1] if state.p.dim() > 1 else None
        upd = {
            k: pool for k in self._pool_shapes()
            if getattr(state, k) is None and (pool := self._zero_pool(k, members)) is not None
        }
        return dataclasses.replace(state, **upd) if upd else state

    def _dirichlet_values(self, t: float) -> torch.Tensor:
        """[n_unodes, dim] with g(x, t) on constrained nodes, 0 elsewhere."""
        vals = [g(coords, t).to(self.dtype) for g, coords in self._bc_groups]
        if not vals:
            return torch.zeros(
                (self.space.n_unodes, self.space.dim), dtype=self.dtype,
                device=self.device,
            )
        return apply_inverse_map(self._bc_inverse, torch.cat(vals, dim=0))

    def _bdf_terms(self, state: State, dt: float):
        """(w, hist, dt_eff): the convection velocity, the mass-history
        combination and the velocity block's effective dt.  BDF2 falls back
        to BDF1 on the first step (no history yet)."""
        if self.config.time.scheme == "bdf2" and state.step > 0:
            w = 2.0 * state.u - state.u_prev
            hist = (4.0 * state.u - state.u_prev) / (2.0 * dt)
            return w, hist, dt / 1.5
        return state.u, state.u / dt, dt

    def _next_history(self, state: State) -> dict:
        """The new state's history fields (u_prev, p_prev, u_prev2)."""
        cfg = self.config
        ext = cfg.solver.extrapolate_guess
        return dict(
            u_prev=state.u if cfg.time.scheme == "bdf2" or ext else None,
            p_prev=state.p if ext else None,
            u_prev2=state.u_prev if state.u_prev2 is not None else None,
        )

    def _external_rhs(self, t: float):
        """The Neumann face's and the forcing's momentum rhs at time t, or
        None when the problem has neither."""
        pb, rhs = self.problem, None
        if self.neumann is not None:
            nt = self.neumann
            h = pb.neumann_value(nt.points, t).to(self.dtype)  # [f, q, dim]
            y = torch.einsum("fq,fqc,fqi->fic", nt.jxw, h, nt.phi_u)
            rhs = apply_segment_plan(nt.plan, y.reshape(-1, self.space.dim))
        if self.ftab is not None:
            ft = self.ftab
            f = pb.forcing(ft.qpoints, t).to(self.dtype)  # [E, q, dim]
            y = torch.einsum("eq,eqc,qi->eic", ft.jxw, f, ft.phi_u)
            f = ops.scatter_u(self.op, y)
            rhs = f if rhs is None else rhs + f
        return rhs

    def _warm_guess(self, state: State):
        """Linear (and with guess_order 2, quadratic for u) extrapolation."""
        if self.config.solver.extrapolate_guess and state.u_prev is not None:
            not_first = 1.0 if state.step > 0 else 0.0
            u_guess = state.u + not_first * (state.u - state.u_prev)
            p_guess = state.p + not_first * (state.p - state.p_prev)
            if state.u_prev2 is not None:
                not_second = 1.0 if state.step > 1 else 0.0
                u_guess = u_guess + not_second * (
                    state.u - 2.0 * state.u_prev + state.u_prev2
                )
            return u_guess, p_guess
        return state.u, state.p

    def _norms(self, x: torch.Tensor):
        """||x||: a float for a vector, [B] numpy for columns [N, B]."""
        precise = self.config.numerics.precise_dots
        return _host_float(_norm(x, precise)) if x.dim() == 1 else _host(_cnorm(x, precise))

    def _tol_kwargs(self, b: torch.Tensor) -> dict:
        """Solver tolerance from the config's tol_mode (the solve is in
        increment form, so "r0" maps to the solver's "b"); per member for
        columns b [N, B]."""
        cfg = self.config
        if cfg.solver.tol_mode == "b":
            return dict(
                rtol=0.0, atol=np.maximum(cfg.solver.rtol * self._norms(b), cfg.solver.atol),
                tol_mode="abs",
            )
        return dict(
            rtol=cfg.solver.rtol, atol=cfg.solver.atol,
            tol_mode="b" if cfg.solver.tol_mode == "r0" else cfg.solver.tol_mode,
        )

    def _poisson_tol(self, tol_kw: dict, rhs_p: torch.Tensor, a_scale: float):
        """(rtol, atol) of the pressure Poisson solve: the velocity solve's
        absolute target, times a_scale (1/dt for the frozen S1, whose system
        is rescaled by it), but never above proj_div_cap * ||rhs_p|| (an
        absolute target above the divergence signal lets the pressure run
        open loop).  Per member for columns rhs_p [n_p, B]."""
        cfg = self.config
        cap = cfg.solver.proj_div_cap * self._norms(rhs_p)
        if tol_kw["tol_mode"] == "abs":
            return 0.0, np.minimum(np.maximum(tol_kw["rtol"], tol_kw["atol"]) * a_scale, cap)
        return cfg.solver.rtol, np.minimum(cfg.solver.atol * a_scale, cap)

    # ------------------------------------------------------------------
    def step(self, state: State, nu: torch.Tensor | None = None):
        """One step of the configured stepper; returns (new_state, per-step
        diagnostics dict of Python numbers and 0-d tensors).  With `nu`, a
        [B] tensor, one step of B members at once, member m with viscosity
        nu[m] (the reference's vmapped step in `run_ensemble`): `state`
        carries the members on a trailing axis, and the diagnostics are [B]
        numpy arrays and [B] tensors."""
        if self.config.time.stepper == "monolithic":
            return self._step_monolithic(state, nu)
        return self._step_projection(state, nu)

    def _pack(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return torch.cat([u.reshape(u.shape[0] * u.shape[1], *u.shape[2:]), p])

    def _unpack(self, x: torch.Tensor):
        n, d = self.space.n_unodes, self.space.dim
        return x[: n * d].view(n, d, *x.shape[1:]), x[n * d:]

    def _fold(self, nu, dt_eff):
        """The step's `convection_setup` fold: (nu, dt_eff), or None with
        numerics.fold_elem=False (no F_e: every element apply evaluates M, A
        and C(w) from the tables)."""
        return (nu, dt_eff) if self.config.numerics.fold_elem else None

    def _members(self, nu):
        """(nu, tail, f_lam0) of a step: the problem's nu, no member axes and
        the set-up F bound for a single run; for an ensemble's [B] nu, the
        trailing member axis and no set-up bound (the reference's
        `run_ensemble` drops it: the smoothers then bound F per member by
        power iteration)."""
        if nu is None:
            return self.problem.nu, (), self._f_lam0
        return nu, (nu.shape[0],), None

    def _step_monolithic(self, state: State, nu=None):
        """One step of the monolithic saddle-point stepper (the reference's
        `_step_dispatch`): the folded F_e and diag C of the step
        (`convection_setup`), the block preconditioner's state, b = (M hist
        with Dirichlet rows g, 0), and flexible GMRES on the increment from
        the extrapolated guess, A = `apply_system`, M = `apply_precond`.
        Its phases run in the projection step's spans: `step.fold`,
        `step.build` (the preconditioner's state), `step.rhs`, `step.guess`
        (x0 and its residual), `step.solve`, `step.update` and
        `step.diagnostics`."""
        with span("step.fold"):
            cfg = self.config
            op, pc = self.op, cfg.precond
            nu, tail, f_lam0 = self._members(nu)
            dt = cfg.time.dt
            t_new = (state.step + 1.0) * dt
            w, hist, dt_eff = self._bdf_terms(state, dt)
            mask = op.dirichlet_mask.view(-1, 1, *(1,) * len(tail))
            conv = ops.convection_setup(op, w, fold=self._fold(nu, dt_eff), backflow=self.backflow)

        with span("step.build"):
            pst = build_precond_state(
                op, nu, dt_eff, conv, pc.kind, s_solver=pc.s_solver, f_solver=pc.f_solver,
                f_lam=f_lam0,
            )

        with span("step.rhs"):
            g = self._dirichlet_values(t_new).view(mask.shape[0], -1, *(1,) * len(tail))
            rhs_u = ops.apply_mass(op, hist)
            ext = self._external_rhs(t_new)
            if ext is not None:
                rhs_u = rhs_u + ext.view(g.shape)
            rhs_u = torch.where(mask, g, rhs_u)
            rhs_p = torch.zeros((self.space.n_pnodes, *tail), dtype=self.dtype, device=self.device)

            def A(x):
                return self._pack(*ops.apply_system(op, nu, dt_eff, conv, *self._unpack(x)))

            def M(x):
                return self._pack(*apply_precond(pc.kind, pc, op, pst, nu, dt_eff, *self._unpack(x)))

            b = self._pack(rhs_u, rhs_p)

        with span("step.guess"):
            u_guess, p_guess = self._warm_guess(state)
            x0 = self._pack(torch.where(mask, g, u_guess), p_guess)
            # increment form: the M/dt bulk of b cancels analytically
            r0 = b - A(x0)

        with span("step.solve"):
            dx, info = fgmres(
                A, r0, M=M, restart=cfg.solver.restart, maxiter=cfg.solver.maxiter,
                precise=cfg.numerics.precise_dots, **self._tol_kwargs(b),
            )

        with span("step.update"):
            u_new, p_new = self._unpack(x0 + dx)
            new_state = State(u=u_new, p=p_new, t=t_new, step=state.step + 1, **self._next_history(state))

        with span("step.diagnostics"):
            diag = self._diagnostics(u_new, p_new, t_new, nu if tail else None)
            diag.update(iters=info.iters, residual=info.residual, iters_f=info.iters,
                        iters_s=np.zeros_like(info.iters) if tail else 0,
                        graphed_s=np.zeros_like(info.iters) if tail else 0)
        return new_state, diag

    def _step_projection(self, state: State, nu=None):
        """One projection step (the reference's `_step_projection`); with a
        [B] nu, B members at once on the element branch that the
        reference's vmapped `run_ensemble` keeps (no macro blocks, no
        assembled K, IMEX fine subset, D or G, no aux divergence, no
        set-up F bound)."""
        with span("step.guess"):
            cfg = self.config
            op, fz, pc = self.op, self.proj_schur, cfg.precond
            nu, tail, f_lam0 = self._members(nu)
            single = not tail
            precise = cfg.numerics.precise_dots
            dt = cfg.time.dt
            t_new = (state.step + 1.0) * dt
            w, hist, dt_eff = self._bdf_terms(state, dt)
            mask = op.dirichlet_mask.view(-1, 1, *(1,) * len(tail))
            n, d = self.space.n_unodes, self.space.dim
            explicit = cfg.time.convection == "explicit"
            macro_rhs = self.macro_rhs and single
            f_apply = self.f_apply if single else "element"
            kcsr = self.kcsr if single else None
            imex = self.imex if single else None

            g = self._dirichlet_values(t_new).view(n, d, *(1,) * len(tail))
            u_guess, p_guess = self._warm_guess(state)
            u0 = torch.where(mask, g, u_guess)

        with span("step.gather"):
            # One gather of the step's node fields.  Macro path: a slot gather
            # of [hist | u0 | pool | w] feeds the rhs pass, and w's element view
            # comes from its slots.  Element path: one element gather (explicit
            # convection gathers u^n, whose N(u^n) its rhs takes).
            warm_f = macro_rhs and pc.f_warmstart > 0 and state.fwpool is not None
            D_ch = None
            if warm_f:
                D_ch = state.fwpool.reshape(pc.f_warmstart, n, d).permute(1, 0, 2).reshape(n, -1)
            x_b = h_e = u0_e = w_e = None
            if self.macro_wfuse and single:
                xs = [hist, u0] + ([D_ch] if warm_f else []) + [w]
                x_b = mb.slot_gather(self.macro, torch.cat(xs, dim=1))
                w_e = mb.slot_expand_elem(self.macro, x_b[..., -d:])
                x_b = x_b[..., :-d]
            elif macro_rhs:
                w_e = ops.gather_u(op, w)
            else:
                wg = state.u if explicit else w
                st_e = ops.gather_u(op, torch.cat([hist, u0, wg], dim=1))
                h_e, u0_e, w_e = st_e[:, :, :d], st_e[:, :, d:2 * d], st_e[:, :, 2 * d:]

        with span("step.fold"):
            conv = conv_rhs = FtT = n_cur = None
            if explicit:
                # N(u^n) = C(u^n)u^n on the rhs (Adams-Bashforth 2 under BDF2
                # after the first step); the velocity block is K
                n_cur = ops.apply_convection_self(op, state.u, w_e=w_e, backflow=self.backflow)
                conv_rhs = n_cur
                if state.conv_prev is not None and cfg.time.scheme == "bdf2" and state.step > 0:
                    conv_rhs = 2.0 * n_cur - state.conv_prev
            else:
                conv = ops.convection_setup(
                    op, w, fold=self._fold(nu, dt_eff), w_e=w_e,
                    with_diag=not pc.freeze_conv_diag,
                    conv_only=self.macro_split and single, backflow=self.backflow,
                )

        with span("step.build"):
            if not explicit and f_apply == "macro":
                FtT = mb.build_macro_values(self.macro, conv.F_e)
                if conv.conv_only:  # K/C split: C's blocks + the setup-time M, A,
                    # added in place (no [B, U, U] temporaries)
                    FtT.add_(self.macro_mass, alpha=1.0 / dt_eff).add_(self.macro_stiff, alpha=nu)

        with span("step.rhs"):
            # ---- 1. tentative velocity -----------------------------------
            Yw = None
            if macro_rhs:
                out = mb.apply_rhs_and_r0_macro(
                    self.macro, self.macro_mass, FtT, hist, u0, extra=D_ch, x_b=x_b
                )
                b_u = out[0] - ops.apply_gradient(op, state.p)
                r0_u = b_u - out[1]
                if warm_f:  # the pool's images under this step's F, masked like Fop
                    FD = torch.where(mask, torch.zeros_like(out[2]), out[2])
                    Yw = FD.reshape(n, pc.f_warmstart, d).permute(1, 0, 2).reshape(pc.f_warmstart, -1)
            else:
                b_u, r0_u = ops.apply_rhs_and_r0(
                    op, hist, state.p, nu, dt_eff, conv, u0, h_e=h_e, u0_e=u0_e,
                    w_e=w_e if op.imex_scale is not None else None,
                )
            if explicit:
                b_u = b_u - conv_rhs
                r0_u = r0_u - conv_rhs
            ext = self._external_rhs(t_new)
            if ext is not None:
                b_u = b_u + ext.view(g.shape)
                r0_u = r0_u + ext.view(g.shape)
            rhs_u = torch.where(mask, g, b_u)
            r0_u = torch.where(mask, torch.zeros_like(r0_u), r0_u)

        with span("step.f_solve"):
            # Fcore: the unmasked operator on [n, C, *tail] for any channel count
            # (the recycled GCR's wide round runs it unless the IMEX fine
            # subset's pass rides every apply).
            fine = kcsr is not None and imex is not None and not explicit
            if kcsr is not None:
                C_ef = ops.convection_fine_fold(op, imex, w_e[imex.f_idx]) if fine else None

                def Fcore(u2):
                    y = apply_csr_scalar(kcsr, u2)
                    if C_ef is not None:
                        y = y + ops.apply_convection_fine(imex, C_ef, u2)
                    return y
            elif FtT is not None:
                def Fcore(u2):
                    return mb.apply_macro(self.macro, FtT, u2)
            else:
                def Fcore(u2):
                    return ops.apply_F(op, nu, dt_eff, conv, u2)

            # the flat vectors the Krylov solves see: [n * d] or [n * d, B]
            def Fop(v):
                u = v.reshape(n, d, *tail)
                return torch.where(mask, u, Fcore(u)).reshape(v.shape)

            # the F preconditioner: plain Jacobi, or with f_iters > 0 the block
            # preconditioners' fixed inner solve; without the frozen S1, the
            # step's S~ and its coarse factor come from the same state (built
            # only when one of the two reads it)
            pst = None
            if pc.f_iters > 0 or fz is None:
                pst = build_precond_state(
                    op, nu, dt_eff, conv, "yosida", s_solver="mg2", f_solver=pc.f_solver,
                    f_lam=f_lam0, skip_schur=fz is not None,
                )
                inv_F = pst.inv_diag_Fhat
            else:
                inv_F = inv_diag_Fhat(op, nu, dt_eff, conv)
            minv = inv_F.unsqueeze(1).expand(n, d, *tail).reshape(n * d, *tail)
            if pc.f_iters > 0:
                def Mf(v):
                    return _solve_F(op, pst, nu, dt_eff, v.reshape(n, d, *tail), pc).reshape(v.shape)
            else:
                def Mf(v):
                    return minv * v
            tol_kw = self._tol_kwargs(rhs_u.reshape(n * d, *tail))
            r0 = r0_u.reshape(n * d, *tail)
            du_e = None
            fpool_new, fwpool_new = state.fpool, state.fwpool
            if pc.f_recycle > 0 and not explicit and not fine and state.fpool is not None:
                def Fop_block(Vc):  # [N, K, *tail] columns
                    u3 = Vc.reshape(n, d, -1, *tail)
                    y = Fcore(u3.reshape(n, -1, *tail)).reshape(u3.shape)
                    return torch.where(mask[:, :, None], u3, y).reshape(Vc.shape)

                du, info_f, Dused = gcr_recycled(
                    Fop_block, r0, lambda Vc: minv[:, None] * Vc, state.fpool,
                    max_narrow=cfg.solver.maxiter, precise=precise, **tol_kw,
                )
                # next pool: the increment, the Jacobi direction, the first
                # narrow directions
                k = pc.f_recycle
                fpool_new = torch.cat([du[None], Dused[:1], Dused[k + 1: 2 * k - 1]])[:k]
            elif explicit:
                # K is SPD on the free subspace: CG
                if tol_kw["tol_mode"] == "abs":
                    cg_rtol, cg_atol = 0.0, np.maximum(tol_kw["rtol"], tol_kw["atol"])
                else:
                    cg_rtol, cg_atol = tol_kw["rtol"], tol_kw["atol"]
                du, info_f = cg(Fop, r0, M=Mf, rtol=cg_rtol, atol=cg_atol,
                                maxiter=cfg.solver.maxiter, precise=precise)
            elif self.aux_div and single:
                def Fop_aux(v):
                    u = v.reshape(n, d)
                    u_e = ops.gather_u(op, u)
                    y = ops.apply_F(op, nu, dt_eff, conv, u, u_e=u_e)
                    return torch.where(mask, u, y).reshape(-1), u_e

                du, info_f, du_e = fgmres(
                    Fop_aux, r0, M=Mf, restart=cfg.solver.restart,
                    maxiter=cfg.solver.maxiter, precise=precise, aux=True, **tol_kw,
                )
            else:
                du_ws = None
                if warm_f:  # project r0 on the pool's exact images first
                    du_ws, r0 = ls_warmstart(state.fwpool, Yw, r0, precise=precise)
                du, info_f = fgmres(
                    Fop, r0, M=Mf, restart=cfg.solver.restart,
                    maxiter=cfg.solver.maxiter, precise=precise, **tol_kw,
                )
                if warm_f:  # harvest the increment beyond the pool's span
                    fwpool_new = torch.cat([du[None], state.fwpool[:-1]])
                    du = du + du_ws
            u_star = u0 + du.reshape(n, d, *tail)

        with span("step.divergence"):
            # ---- 2. pressure Poisson: S~ phi = -D u* ---------------------
            rhs_p = -ops.apply_divergence(op, u_star) if du_e is None else (
                # u*'s element view from the step's gather and the Krylov applies
                -ops.apply_divergence_e(op, u0_e + du_e)
            )

        with span("step.s_solve"):
            if fz is not None:
                # S~ = dt S1 with S1 frozen at set-up: solve S1 phi = rhs / dt
                rhs_p = rhs_p / dt_eff
                a_scale, upd_inv = 1.0 / dt_eff, dt_eff * fz.inv1
            else:  # the step's S~ (proj_schur="step")
                a_scale, upd_inv = 1.0, pst.schur_inv
            S, M2 = self._pressure_operators(fz, pst)

            s_rtol, s_atol = self._poisson_tol(tol_kw, rhs_p, a_scale)
            phi0 = p_guess - state.p
            gkw = self._s_graphs(fz)
            replays = self._cg_graphs.replays
            if pc.s_recycle > 0 and fz is not None and state.spool is not None:
                phi, info_s, harvest = cg_recycled(
                    S, rhs_p, M2, phi0, state.spool[0], state.spool[1],
                    rtol=s_rtol, atol=s_atol, maxiter=cfg.solver.maxiter,
                    precise=precise, **gkw,
                )
                spool_new = torch.cat([harvest[:, None], state.spool[:, :-1]], dim=1)
            else:
                phi, info_s = cg(
                    S, rhs_p, M=M2, x0=phi0, rtol=s_rtol, atol=s_atol,
                    maxiter=cfg.solver.maxiter, precise=precise, **gkw,
                )
                spool_new = state.spool
            replays = self._cg_graphs.replays - replays

        with span("step.update"):
            # ---- 3. update -------------------------------------------------
            p_new = state.p + phi
            u_new = u_star - upd_inv.view(n, 1, *(1,) * len(tail)) * ops.apply_gradient(op, phi)

            new_state = State(
                u=u_new, p=p_new, t=t_new, step=state.step + 1, **self._next_history(state),
                conv_prev=n_cur if explicit and state.conv_prev is not None else None,
                spool=spool_new, fpool=fpool_new, fwpool=fwpool_new,
            )

        with span("step.diagnostics"):
            diag = self._diagnostics(u_new, p_new, t_new, None if single else nu)
            diag.update(
                iters=info_f.iters + info_s.iters,
                residual=np.maximum(info_f.residual, info_s.residual),
                iters_f=info_f.iters, iters_s=info_s.iters,
                graphed_s=replays if single else np.full(tail, replays),
            )
        return new_state, diag

    def _pressure_operators(self, fz: FrozenSchur | None, pst=None):
        """(S, M): the pressure CG's operator and two-level preconditioner,
        on the frozen S1 (its coarse factor's inverse) or, with fz None, on
        the step's S~ in `pst` (its coarse factor's triangular solves)."""
        op, pc = self.op, self.config.precond
        if fz is not None:
            inv_d = fz.inv_d
            solve_c = cho_w_solve_c(fz.cho_w) if fz.inv_c is None else inv_solve_c(fz.inv_c)
            if fz.band is not None:
                def S(pv):
                    return banded_matvec(fz.band, pv)
            else:
                def S(pv):
                    return schur_ell_matvec(op.schur, fz.vals1, pv)
        else:
            inv_d = 1.0 / pst.schur_diag
            solve_c = cho_solve_c(pst.schur_cho_L)

            def S(pv):
                return schur_ell_matvec(op.schur, pst.schur_vals, pv)

        if pc.mg2_form == "additive":
            def M(v):
                return twolevel_apply_additive_g(op.coarse, solve_c, inv_d, v)
        else:
            def M(v):
                return twolevel_apply_g(op.coarse, solve_c, S, inv_d, v)
        return S, M

    def _s_graphs(self, fz: FrozenSchur | None) -> dict:
        """The pressure CG's graph arguments (`solvers/krylov.py CGGraphs`)
        where its operators never change: the frozen S1 and its two-level
        preconditioner, built once at set-up, on the card, with no process
        group (a sharded operator's); none elsewhere."""
        if fz is None or self.device.type != "cuda" or self.op.group is not None:
            return {}
        return dict(graphs=self._cg_graphs)

    def _diagnostics(self, u, p, t, nu=None) -> dict:
        """drag, lift, c_d, c_l and delta_p: 0-d tensors, or [B] for an
        ensemble (p [n_p, B], nu [B])."""
        zero = torch.zeros(p.shape[1:], dtype=self.dtype, device=self.device)
        drag = lift = c_d = c_l = delta_p = zero
        pb = self.problem
        nu = pb.nu if nu is None else nu
        if self.forces is not None:
            if self.space.dim == 2:
                drag, lift = fn.forces_2d(self.forces, u, p, nu)
            else:
                drag, lift = fn.forces_3d(self.forces, u, p, nu, pb.rho)
            if pb.mean_velocity is not None:
                c_d, c_l = fn.drag_lift_coefficients(
                    drag, lift, pb.mean_velocity(t), pb.diameter, pb.span, pb.rho
                )
        if self.probe is not None:
            pv = self.probe.pressure(p)
            delta_p = pv[0] - pv[1]
        return dict(drag=drag, lift=lift, c_d=c_d, c_l=c_l, delta_p=delta_p)

    # ------------------------------------------------------------------
    def run(self, n_steps: int, state: State | None = None, callback: Callable | None = None):
        """Advance `n_steps` in chunks of numerics.steps_per_chunk steps (the
        reference's `run`).  After each chunk its diagnostics come to the
        host as numpy arrays (one sync a chunk), a non-finite residual raises
        FloatingPointError, a chunk whose every step hit maxiter warns, and
        `callback(solver, state, diags_chunk)` fires (the CLI's CSV, VTU and
        checkpoint writer).  Returns (state, the stacked StepDiagnostics)."""
        state = self.initial_state() if state is None else self._ensure_pools(state)
        if n_steps <= 0:  # e.g. resuming a finished run
            return state, _stack_diagnostics([])
        chunk = max(1, self.config.numerics.steps_per_chunk)
        maxit = self.config.solver.maxiter
        chunks, done = [], 0
        while done < n_steps:
            k = min(chunk, n_steps - done)
            rows = []
            for _ in range(k):
                state, dg = self.step(state)
                rows.append(dg)
            with span("run.host_copy"):
                d = _stack_diagnostics(rows)
            done += k
            chunks.append(d)
            if not np.all(np.isfinite(d.residual)):
                raise FloatingPointError(
                    f"solver diverged: non-finite residual at step {done} "
                    f"(residuals {d.residual})"
                )
            if np.all(np.maximum(d.iters_f, d.iters_s) >= maxit):
                warnings.warn(
                    f"outer GMRES hit maxiter={maxit} for an entire chunk at step "
                    f"{done}; solution may be inaccurate (consider stronger "
                    "preconditioning)",
                    stacklevel=2,
                )
            if callback is not None:
                callback(self, state, d)
        return state, StepDiagnostics(**{
            f.name: np.concatenate([getattr(c, f.name) for c in chunks])
            for f in dataclasses.fields(StepDiagnostics)
        })


def _stack_diagnostics(rows: list) -> StepDiagnostics:
    """Per-step diagnostics dicts -> StepDiagnostics of numpy arrays (the
    tensors in one stack and one copy to the host)."""
    cols = {}
    for f in dataclasses.fields(StepDiagnostics):
        vals = [r[f.name] for r in rows]
        if vals and isinstance(vals[0], torch.Tensor):
            stacked = torch.stack(vals)
            with span("host_read"):
                cols[f.name] = stacked.cpu().numpy()
        else:
            counts = "iters" in f.name or f.name == "graphed_s"
            cols[f.name] = np.asarray(vals, dtype=np.int64 if counts else np.float64)
    return StepDiagnostics(**cols)
