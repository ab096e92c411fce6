"""Time-stepping Navier-Stokes solver (PyTorch): setup, projection step, run.

The counterpart of the reference's `models/base.py` for the configurations
the benchmark (bench.py) and the ensemble sweep (scripts/bench_ensemble.py,
`cli.py ensemble --fast`) run: the incremental pressure-correction
(projection) stepper with implicit linearised convection, BDF1, a
Jacobi-preconditioned FGMRES velocity solve, and the frozen Schur pressure
Poisson over the banded S1 with the additive two-level preconditioner,
solved by recycled-projection CG (precond.s_recycle >= 1) or plain CG
(s_recycle = 0).  A configuration outside that slice is rejected with
ValueError.

One single-run step (`step`, the macro branch of the reference's
`_step_projection`):

  1. one slot gather of [hist | u0 | w]; w's element view from the slots;
  2. F_e = M/dt + nu A + C(w) per element (`convection_setup`), then the
     block values FtT (kernel B);
  3. (M hist, F u0) from the slot view (kernel A), G p_n from the assembled
     gradient: b = M hist - G p_n, r0 = b - F u0;
  4. FGMRES on F du = r0 (kernel A every iteration), u* = u0 + du;
  5. S1 phi = -D u* / dt with CG; p = p_n + phi;
     u = u* - dt diag(M)^-1 G phi on free nodes;
  6. drag, lift and the pressure difference.

One ensemble step (`step_ensemble`, the element branch that the
reference's vmapped `run_ensemble` takes) does the same for B members at
once, each with its own nu, carried on a trailing member axis: the
element passes move all members as packed channels through the slot
gather and reduce (kernels D and C), and the Krylov solves are batched
(`fgmres`, `cg` on [n, B] columns) with per-member tolerances and
counts.
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
from navierstokes_project_nm4pde_tpu_torch.ops.coarse import (
    cho_solve_c,
    host_coarse_dense,
    twolevel_apply_additive_g,
)
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    apply_inverse_map,
    build_inverse_map,
)
from navierstokes_project_nm4pde_tpu_torch.precond.blocks import inv_diag_Fhat
from navierstokes_project_nm4pde_tpu_torch.solvers.krylov import (
    SolveInfo,
    _cnorm,
    _host,
    _norm,
    cg,
    cg_recycled,
    fgmres,
)


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Physics and boundary data of one problem; callables take torch
    tensors and a float time."""

    dim: int
    nu: float
    rho: float = 1.0
    # Dirichlet: tag -> g(x[n, dim], t) -> [n, dim]
    dirichlet: dict = dataclasses.field(default_factory=dict)
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
    u_prev: torch.Tensor | None = None  # u^{n-1} (warm-start extrapolation)
    p_prev: torch.Tensor | None = None  # p^{n-1}
    u_prev2: torch.Tensor | None = None  # u^{n-2} (guess_order=2)
    # [2, k, n_p]: recycled pressure directions and their exact S1 images
    # (precond.s_recycle = k >= 1; None with plain CG)
    spool: torch.Tensor | None = None


_STATE_ARRAYS = ("u", "p", "u_prev", "p_prev", "u_prev2", "spool")


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
        u=conv("u"), p=conv("p"), t=float(np.asarray(get("t"))),
        step=int(np.asarray(get("step"))), u_prev=conv("u_prev"),
        p_prev=conv("p_prev"), u_prev2=conv("u_prev2"), spool=conv("spool"),
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


@dataclasses.dataclass
class FrozenSchur:
    """Setup-time data of the pressure Poisson S1 phi = rhs / dt."""

    inv1: torch.Tensor  # [n_unodes] 1/diagM on free nodes, 0 constrained
    diag1: torch.Tensor  # [n_p] diagonal of S1
    cho_L: torch.Tensor  # dense lower Cholesky factor of the coarse matrix
    band: BandedSchur


# Values that only chose a TPU layout or engine; every one of them is the
# same operator here.
_LAYOUT_ONLY = {
    "macro_build": ("auto", "highest", "split3"),
    "macro_apply": ("auto", "highest", "split3"),
    "grad_apply": ("auto", "bsr"),
    "div_apply": ("auto", "bsr"),
    "f_apply": ("auto", "macro"),
    "macro_rhs": ("auto", "on"),
    "macro_wfuse": ("auto", "on"),
    "macro_split": ("auto", "off"),
    "schur_spmv": ("auto", "banded"),
    # the reference's one-hot ensemble reductions accumulate in f32 (its
    # MXU path); here every ensemble reduction is the exact kernel C
    "ensemble_onehot": (False, True),
}


def check_config(cfg: RunConfig, problem: ProblemSpec) -> None:
    """Raise ValueError for a configuration this port does not run yet."""
    req = [
        ("time.stepper", cfg.time.stepper, ("projection",)),
        ("time.convection", cfg.time.convection, ("implicit",)),
        ("time.scheme", cfg.time.scheme, ("bdf1",)),
        ("numerics.proj_schur", cfg.numerics.proj_schur, ("frozen",)),
        ("numerics.coarse_solve", cfg.numerics.coarse_solve, ("chol",)),
        ("numerics.dtype", cfg.numerics.dtype, ("float32", "float64")),
        ("numerics.fold_elem", cfg.numerics.fold_elem, (True,)),
        ("numerics.spatial_reorder", cfg.numerics.spatial_reorder, (True,)),
        ("precond.mg2_form", cfg.precond.mg2_form, ("additive",)),
        ("precond.f_iters", cfg.precond.f_iters, (0,)),
        ("precond.f_solver", cfg.precond.f_solver, ("gmres",)),
        ("precond.f_recycle", cfg.precond.f_recycle, (0,)),
        ("precond.f_warmstart", cfg.precond.f_warmstart, (0,)),
        ("solver.tol_mode", cfg.solver.tol_mode, ("r0", "b", "abs")),
        ("solver.guess_order", cfg.solver.guess_order, (1, 2)),
        ("problem.dim", problem.dim, (3,)),
    ]
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
    if cfg.precond.s_recycle < 0:
        raise ValueError("precond.s_recycle must be >= 0")


class NavierStokesSolver:
    """Projection-stepper solver for one `ProblemSpec` on one mesh (the
    port's own `mesh.Mesh`), on `device`: None means the card, and raises
    without one; "cpu" runs the kernels' plain versions."""

    def __init__(self, mesh, problem: ProblemSpec, config: RunConfig, device=None):
        check_config(config, problem)
        self.problem = problem
        self.config = config
        self.device = pick_device(device)
        self.dtype = torch_dtype(config.numerics.dtype)
        self._setup(mesh)

    # ------------------------------------------------------------------
    def _setup(self, mesh):
        cfg, dev, dt_ = self.config, self.device, self.dtype
        # RCM: the banded Schur and the macro blocks both need bounded
        # index windows.
        self.mesh = mesh.reorder_spatial("rcm")
        self.space = build_taylor_hood(self.mesh)
        self.geom = cell_geometry(self.space)
        space = self.space
        dtags = sorted(self.problem.dirichlet.keys())
        mask = space.dirichlet_mask(dtags)
        self.op, host = ops.build_operator(
            space, self.geom, mask, dt_, dev, coarse_agg=cfg.numerics.schur_agg
        )
        self.conv_base = ops.conv_base(self.op)

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

        # Frozen Schur S1 = D diag(M)^-1 D^T, its coarse factor and banded
        # form, once on the host in float64.
        mask_np = np.asarray(mask, dtype=bool)
        inv1 = np.where(mask_np, 0.0, 1.0 / host["diagM"])
        vals1 = host["vals1"]
        diag1 = vals1[host["diag_slot"]]
        diag1 = np.where(diag1 > 0, diag1, 1.0)
        cs = self.op.coarse
        Sc = host_coarse_dense(host, vals1, cs.nc, cs.agg)
        smask = host["smask"]
        band = build_banded_schur(
            host["srow"][smask], host["scol"][smask], vals1[smask],
            n_rows=len(diag1), dtype=dt_, device=dev,
        )
        if band is None:
            raise ValueError(
                "the RCM band of S1 is too wide for the banded form (the ELL "
                "SpMV fallback is not ported)"
            )
        self.proj_schur = FrozenSchur(
            inv1=torch.as_tensor(inv1, dtype=dt_, device=dev),
            diag1=torch.as_tensor(diag1, dtype=dt_, device=dev),
            cho_L=torch.as_tensor(np.linalg.cholesky(Sc), dtype=dt_, device=dev),
            band=band,
        )

    @functools.cached_property
    def macro(self) -> mb.MacroPlan:
        """The single run's macro-block plan, built at first use (the
        ensemble step never reads it)."""
        nc = self.config.numerics
        return mb.build_macro_plan(
            self.space.cells_u, self.space.n_unodes, U=nc.macro_u,
            c_blk=nc.macro_cblk, device=self.device,
        )

    @functools.cached_property
    def macro_mass(self) -> torch.Tensor:
        """The mass matrix's macro blocks (single run; at first use)."""
        return mb.build_macro_mass(self.macro, self.op.MHAT, self.op.detJ)

    # ------------------------------------------------------------------
    def initial_state(self, members: int | None = None) -> State:
        """The state at rest; with `members`, an ensemble state of that
        many members (trailing member axis, no recycle pool)."""
        n, d = self.space.n_unodes, self.space.dim
        tail = () if members is None else (members,)
        u = torch.zeros((n, d, *tail), dtype=self.dtype, device=self.device)
        p = torch.zeros((self.space.n_pnodes, *tail), dtype=self.dtype, device=self.device)
        ext = self.config.solver.extrapolate_guess
        quad = ext and self.config.solver.guess_order >= 2
        return State(
            u=u, p=p, t=0.0, step=0,
            u_prev=u if ext else None,
            p_prev=p if ext else None,
            u_prev2=u if quad else None,
            spool=self._zero_spool() if members is None else None,
        )

    def _zero_spool(self) -> torch.Tensor | None:
        k = self.config.precond.s_recycle
        if k == 0:
            return None
        return torch.zeros(
            (2, k, self.space.n_pnodes), dtype=self.dtype, device=self.device
        )

    def _ensure_pools(self, state: State) -> State:
        """Give an externally supplied state the recycle pool it lacks
        (a zero pool is always valid)."""
        if state.spool is None:
            return dataclasses.replace(state, spool=self._zero_spool())
        return state

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
        """(w, hist, dt_eff) of BDF1."""
        return state.u, state.u / dt, dt

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
        return float(_norm(x, precise)) if x.dim() == 1 else _host(_cnorm(x, precise))

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

    def _poisson_tol(self, tol_kw: dict, rhs_p: torch.Tensor, dt_eff: float):
        """(rtol, atol) of the pressure Poisson solve: the velocity solve's
        absolute target, rescaled by 1/dt, but never above proj_div_cap *
        ||rhs_p|| (an absolute target above the divergence signal lets the
        pressure run open loop).  Per member for columns rhs_p [n_p, B]."""
        cfg = self.config
        cap = cfg.solver.proj_div_cap * self._norms(rhs_p)
        if tol_kw["tol_mode"] == "abs":
            return 0.0, np.minimum(np.maximum(tol_kw["rtol"], tol_kw["atol"]) / dt_eff, cap)
        return cfg.solver.rtol, np.minimum(cfg.solver.atol / dt_eff, cap)

    # ------------------------------------------------------------------
    def step(self, state: State):
        """One projection step; returns (new_state, per-step diagnostics
        dict of Python numbers and 0-d tensors)."""
        cfg = self.config
        op, mp, fz = self.op, self.macro, self.proj_schur
        nu = self.problem.nu
        precise = cfg.numerics.precise_dots
        dt = cfg.time.dt
        t_new = (state.step + 1.0) * dt
        w, hist, dt_eff = self._bdf_terms(state, dt)
        mask = op.dirichlet_mask[:, None]
        n, d = self.space.n_unodes, self.space.dim

        g = self._dirichlet_values(t_new)
        u_guess, p_guess = self._warm_guess(state)
        u0 = torch.where(mask, g, u_guess)

        # One slot gather for the step: [hist | u0] feed the rhs pass, w's
        # element view comes from its slots.
        x_b = mb.slot_gather(mp, torch.cat([hist, u0, w], dim=1))
        w_e = mb.slot_expand_elem(mp, x_b[..., 2 * d:])
        conv = ops.convection_setup(
            op, w, fold=(nu, dt_eff), w_e=w_e,
            with_diag=not cfg.precond.freeze_conv_diag, base_e=self.conv_base,
        )
        FtT = mb.build_macro_values(mp, conv.F_e)

        # ---- 1. tentative velocity -----------------------------------
        Mh, Fu0 = mb.apply_rhs_and_r0_macro(
            mp, self.macro_mass, FtT, hist, u0, x_b=x_b
        )
        b_u = Mh - ops.apply_gradient(op, state.p)
        r0_u = b_u - Fu0
        rhs_u = torch.where(mask, g, b_u)
        r0_u = torch.where(mask, torch.zeros_like(r0_u), r0_u)

        def Fop(v):
            u = v.reshape(n, d)
            return torch.where(mask, u, mb.apply_macro(mp, FtT, u)).reshape(-1)

        minv = inv_diag_Fhat(op, nu, dt_eff, conv)[:, None].expand(n, d).reshape(-1)
        tol_kw = self._tol_kwargs(rhs_u.reshape(-1))
        du, info_f = fgmres(
            Fop, r0_u.reshape(-1), M=lambda v: minv * v,
            restart=cfg.solver.restart, maxiter=cfg.solver.maxiter,
            precise=precise, **tol_kw,
        )
        u_star = u0 + du.reshape(n, d)

        # ---- 2. pressure Poisson with the frozen S1 -------------------
        rhs_p = -ops.apply_divergence(op, u_star) / dt_eff
        solve_c = cho_solve_c(fz.cho_L)
        inv_d = 1.0 / fz.diag1

        def S(pv):
            return banded_matvec(fz.band, pv)

        def M2(v):
            return twolevel_apply_additive_g(op.coarse, solve_c, inv_d, v)

        s_rtol, s_atol = self._poisson_tol(tol_kw, rhs_p, dt_eff)
        phi0 = p_guess - state.p
        if cfg.precond.s_recycle > 0 and state.spool is not None:
            phi, info_s, harvest = cg_recycled(
                S, rhs_p, M2, phi0, state.spool[0], state.spool[1],
                rtol=s_rtol, atol=s_atol, maxiter=cfg.solver.maxiter,
                precise=precise,
            )
            spool_new = torch.cat([harvest[:, None, :], state.spool[:, :-1]], dim=1)
        else:
            phi, info = cg(
                S, rhs_p[:, None], M=M2, x0=phi0[:, None], rtol=s_rtol,
                atol=s_atol, maxiter=cfg.solver.maxiter, precise=precise,
            )
            phi, spool_new = phi[:, 0], None
            info_s = SolveInfo(iters=int(info.iters[0]), residual=float(info.residual[0]))

        # ---- 3. update -------------------------------------------------
        p_new = state.p + phi
        u_new = u_star - (dt_eff * fz.inv1)[:, None] * ops.apply_gradient(op, phi)

        ext = cfg.solver.extrapolate_guess
        new_state = State(
            u=u_new, p=p_new, t=t_new, step=state.step + 1,
            u_prev=state.u if ext else None,
            p_prev=state.p if ext else None,
            u_prev2=state.u_prev if state.u_prev2 is not None else None,
            spool=spool_new,
        )
        diag = self._diagnostics(u_new, p_new, t_new)
        diag.update(
            iters=info_f.iters + info_s.iters,
            residual=max(info_f.residual, info_s.residual),
            iters_f=info_f.iters, iters_s=info_s.iters,
        )
        return new_state, diag

    # ------------------------------------------------------------------
    def step_ensemble(self, state: State, nu: torch.Tensor):
        """One projection step of B members at once (the element branch of
        the reference's `_step_projection`, as its vmapped `run_ensemble`
        runs it), member m with viscosity nu[m]; `state` carries the
        members on a trailing axis.  Returns (new_state, per-step
        diagnostics dict of [B] numpy arrays and [B] tensors)."""
        cfg = self.config
        if cfg.precond.s_recycle != 0:
            raise ValueError(
                "the PyTorch port's ensemble solves the pressure with plain "
                "CG: it needs precond.s_recycle=0"
            )
        op, fz = self.op, self.proj_schur
        precise = cfg.numerics.precise_dots
        dt = cfg.time.dt
        t_new = (state.step + 1.0) * dt
        w, hist, dt_eff = self._bdf_terms(state, dt)
        n, d = self.space.n_unodes, self.space.dim
        B = nu.shape[0]
        mask = op.dirichlet_mask[:, None, None]

        g = self._dirichlet_values(t_new)[:, :, None]
        u_guess, p_guess = self._warm_guess(state)
        u0 = torch.where(mask, g, u_guess)

        # One element gather of [hist | u0 | w] (576 channels at B = 64).
        st_e = ops.gather_u(op, torch.cat([hist, u0, w], dim=1))
        h_e, u0_e, w_e = st_e[:, :, :d], st_e[:, :, d:2 * d], st_e[:, :, 2 * d:]
        conv = ops.convection_setup(
            op, w, fold=(nu, dt_eff), w_e=w_e,
            with_diag=not cfg.precond.freeze_conv_diag, base_e=self.conv_base,
        )

        # ---- 1. tentative velocity -----------------------------------
        b_u, r0_u = ops.apply_rhs_and_r0(
            op, hist, state.p, nu, dt_eff, conv, u0, h_e=h_e, u0_e=u0_e
        )
        rhs_u = torch.where(mask, g, b_u)
        r0_u = torch.where(mask, torch.zeros_like(r0_u), r0_u)

        def Fop(v):
            u = v.reshape(n, d, B)
            return torch.where(mask, u, ops.apply_F(op, nu, dt_eff, conv, u)).reshape(n * d, B)

        minv = inv_diag_Fhat(op, nu, dt_eff, conv)[:, None, :].expand(n, d, B).reshape(n * d, B)
        tol_kw = self._tol_kwargs(rhs_u.reshape(n * d, B))
        du, info_f = fgmres(
            Fop, r0_u.reshape(n * d, B), M=lambda v: minv * v,
            restart=cfg.solver.restart, maxiter=cfg.solver.maxiter,
            precise=precise, **tol_kw,
        )
        u_star = u0 + du.reshape(n, d, B)

        # ---- 2. pressure Poisson with the frozen S1 (shared) ----------
        rhs_p = -ops.apply_divergence_e(op, ops.gather_u(op, u_star)) / dt_eff
        solve_c = cho_solve_c(fz.cho_L)
        inv_d = 1.0 / fz.diag1

        def S(pv):
            return banded_matvec(fz.band, pv)

        def M2(v):
            return twolevel_apply_additive_g(op.coarse, solve_c, inv_d, v)

        s_rtol, s_atol = self._poisson_tol(tol_kw, rhs_p, dt_eff)
        phi, info_s = cg(
            S, rhs_p, M=M2, x0=p_guess - state.p, rtol=s_rtol, atol=s_atol,
            maxiter=cfg.solver.maxiter, precise=precise,
        )

        # ---- 3. update (element gradient) --------------------------------
        p_new = state.p + phi
        u_new = u_star - (dt_eff * fz.inv1)[:, None, None] * ops.apply_gradient_e(op, phi)

        ext = cfg.solver.extrapolate_guess
        new_state = State(
            u=u_new, p=p_new, t=t_new, step=state.step + 1,
            u_prev=state.u if ext else None,
            p_prev=state.p if ext else None,
            u_prev2=state.u_prev if state.u_prev2 is not None else None,
        )
        diag = self._diagnostics(u_new, p_new, t_new, nu)
        diag.update(
            iters=info_f.iters + info_s.iters,
            residual=np.maximum(info_f.residual, info_s.residual),
            iters_f=info_f.iters, iters_s=info_s.iters,
        )
        return new_state, diag

    def _diagnostics(self, u, p, t, nu=None) -> dict:
        """drag, lift, c_d, c_l and delta_p: 0-d tensors, or [B] for an
        ensemble (p [n_p, B], nu [B])."""
        zero = torch.zeros(p.shape[1:], dtype=self.dtype, device=self.device)
        drag = lift = c_d = c_l = delta_p = zero
        pb = self.problem
        nu = pb.nu if nu is None else nu
        if self.forces is not None:
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
    def run(self, n_steps: int, state: State | None = None):
        """Advance `n_steps` in a Python loop; returns (state, stacked
        StepDiagnostics as numpy arrays)."""
        state = self.initial_state() if state is None else self._ensure_pools(state)
        rows = []
        for _ in range(max(n_steps, 0)):
            state, dg = self.step(state)
            if not np.isfinite(dg["residual"]):
                raise FloatingPointError(
                    f"solver diverged: non-finite residual at step {state.step}"
                )
            rows.append(dg)
        maxit = self.config.solver.maxiter
        if rows and all(max(r["iters_f"], r["iters_s"]) >= maxit for r in rows):
            warnings.warn(
                f"every step hit maxiter={maxit}; the solution may be inaccurate",
                stacklevel=2,
            )
        fields = [f.name for f in dataclasses.fields(StepDiagnostics)]
        cols = {}
        for k in fields:
            vals = [r[k] for r in rows]
            if vals and isinstance(vals[0], torch.Tensor):
                cols[k] = torch.stack(vals).cpu().numpy()
            else:
                cols[k] = np.asarray(vals, dtype=np.int64 if "iters" in k else np.float64)
        return state, StepDiagnostics(**cols)
