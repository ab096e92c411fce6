"""A whole projection step under the owned+halo layout, one rank of a
process group.

The counterpart of the reference's `parallel/halo_step.py`, which carries
the owned/ghost model of `parallel/halo.py` through a complete step
(ref: src/NavierStokes2D.cpp:71-87 owned and relevant DoFs, :315-320
compress()).  Every rank builds this step from the same solver and calls
it in lockstep (`state_from_numpy` / `state_to_numpy` carry a state to
and from the reference's HaloStepState):

  * velocity (most of the DoFs) is held in the owned layout: each rank its
    block; every element pass gathers the halo slabs and returns the ghost
    rows' sums to their owners (`HaloExchange`, kernels D and C on the
    rank's slot plan), and every FGMRES dot product is all-reduced over the
    group (`solvers/krylov.py`, `group`), so that every rank stops on the
    same norms;
  * pressure is replicated: the divergence rhs is one all-reduce of the
    ranks' partial assemblies, and the frozen-Schur CG (banded or ELL, the
    additive two-level preconditioner, all set-up constants) runs the same
    on every rank.

It carries BDF1/BDF2, the guess_order 1/2 warm start and the recycled
frozen-Schur pool (s_recycle), and asserts the reference's other limits
(implicit convection, the Jacobi F preconditioner, the frozen Schur,
tol_mode "b", no forcing, Neumann face or backflow).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.ops.banded import banded_matvec
from navierstokes_project_nm4pde_tpu_torch.ops.coarse import (
    cho_w_solve_c,
    inv_solve_c,
    twolevel_apply_additive_g,
)
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import apply_segment_plan, build_segment_plan
from navierstokes_project_nm4pde_tpu_torch.ops.schur_ell import schur_ell_matvec
from navierstokes_project_nm4pde_tpu_torch.parallel.halo import (
    HaloExchange,
    build_halo_plan,
    owned_block,
)
from navierstokes_project_nm4pde_tpu_torch.parallel.sharding import _pad_cells, shard_operator
from navierstokes_project_nm4pde_tpu_torch.precond.blocks import build_precond_state
from navierstokes_project_nm4pde_tpu_torch.solvers.krylov import (
    _cnorm,
    cg,
    cg_recycled,
    fgmres,
)


@dataclasses.dataclass
class HaloStepState:
    """One rank's step state: velocity fields in its owned block, pressure
    fields replicated (the reference's HaloStepState)."""

    u: torch.Tensor  # [n_loc, dim] owned block
    p: torch.Tensor  # [n_p] replicated
    step: int
    u_prev: torch.Tensor | None = None  # BDF2 / extrapolation history (owned)
    u_prev2: torch.Tensor | None = None  # guess_order=2 history (owned)
    p_prev: torch.Tensor | None = None  # pressure extrapolation history
    spool: torch.Tensor | None = None  # [2, k, n_p] recycled (d, S1 d) rows


_STATE_ARRAYS = ("u", "p", "u_prev", "u_prev2", "p_prev", "spool")
_OWNED = ("u", "u_prev", "u_prev2")  # the velocity fields: owned blocks


class HaloProjectionStep:
    """Callable one-step driver of one rank: HaloStepState ->
    (HaloStepState, (f_iters, s_iters)).  Built once per (solver, group) on
    every rank of `group`; `init_state`, `shard` and `unshard` move states
    into and out of the owned layout."""

    def __init__(self, solver, group):
        import torch.distributed as dist

        cfg, t = solver.config, solver.config.time
        assert t.stepper == "projection", "halo step: projection stepper"
        assert t.scheme in ("bdf1", "bdf2")
        assert t.convection == "implicit", "halo step: implicit convection"
        assert cfg.precond.f_iters == 0, "halo step: Jacobi-diag F precond"
        assert cfg.precond.mg2_form == "additive"
        assert cfg.solver.tol_mode == "b"
        fz = solver.proj_schur
        assert fz is not None, "halo step needs the frozen projection Schur"
        assert solver.backflow is None
        assert solver.problem.forcing is None
        assert solver.neumann is None

        self.solver, self.group, self.fz = solver, group, fz
        self.rank, self.n_dev = dist.get_rank(group), dist.get_world_size(group)
        self.device, self.dtype = solver.device, solver.dtype
        self._bdf2 = t.scheme == "bdf2"
        self._extrap = cfg.solver.extrapolate_guess
        self._quad = self._extrap and cfg.solver.guess_order >= 2
        self._srec = cfg.precond.s_recycle

        op = solver.op
        # the plan works on the cell-padded operator; shard_operator pads
        # the same way and keeps this rank's cell block
        op_pad = _pad_cells(op, self.n_dev)
        self.plan = build_halo_plan(op_pad, self.n_dev, n_vertices=solver.mesh.n_vertices)
        self.op_sh = shard_operator(op, group)
        self.ex_u = HaloExchange(self.plan.u, group, self.device)
        # the replicated pressure needs no halo: this rank's natural-id
        # pressure cells and their slot plan onto the pressure rows
        cp = op_pad.cells_p[self.op_sh.cells_p.shape[0] * self.rank:][: self.op_sh.cells_p.shape[0]]
        self.cp_nat = cp.contiguous()
        self.plan_p = build_segment_plan(cp.cpu().numpy(), solver.space.n_pnodes, device=self.device)

        # freeze_conv_diag semantics: the convection-free Jacobi diagonal
        pst = build_precond_state(op, solver.problem.nu, t.dt, None, "yosida", s_solver="mg2",
                                  f_solver=cfg.precond.f_solver, skip_schur=True)
        own = self.shard
        self.mask = own(op.dirichlet_mask.to(self.dtype)[:, None])[:, 0] > 0.5
        self.invdiag = own(pst.inv_diag_Fhat[:, None])[:, 0]
        self.inv1 = own(fz.inv1[:, None])[:, 0]
        self.inv_d = fz.inv_d
        self.solve_c = cho_w_solve_c(fz.cho_w) if fz.inv_c is None else inv_solve_c(fz.inv_c)

    # -- layout helpers ------------------------------------------------
    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's owned block of a natural-order velocity field."""
        return torch.as_tensor(owned_block(self.plan.u, x.cpu().numpy(), self.rank), device=self.device)

    def _owned_layout(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's owned block in rank order [n_dev * n_loc, ...] (one
        all-reduce of the zero-padded layout; a collective)."""
        import torch.distributed as dist

        n_loc = self.plan.u.n_loc
        full = torch.zeros((self.n_dev * n_loc,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        full[self.rank * n_loc:(self.rank + 1) * n_loc] = x
        dist.all_reduce(full, group=self.group)
        return full

    def unshard(self, u_own: torch.Tensor) -> torch.Tensor:
        """The natural-order field from every rank's owned block (a
        collective; every rank gets it)."""
        full = self._owned_layout(u_own)
        return full[torch.as_tensor(self.plan.u.perm, device=full.device)]

    def state_from_numpy(self, arrays) -> HaloStepState:
        """This rank's state from the reference's HaloStepState (numpy
        arrays: velocity fields in the whole owned layout [n_dev * n_loc,
        dim], pressure fields replicated), given as a mapping or as any
        object with those attribute names."""
        get = arrays.get if isinstance(arrays, dict) else (lambda k: getattr(arrays, k, None))
        blk = slice(self.rank * self.plan.u.n_loc, (self.rank + 1) * self.plan.u.n_loc)

        def conv(k):
            v = get(k)
            if v is None:
                return None
            v = np.array(v)
            return torch.as_tensor(v[blk] if k in _OWNED else v, dtype=self.dtype, device=self.device)

        return HaloStepState(step=int(np.asarray(get("step"))), **{k: conv(k) for k in _STATE_ARRAYS})

    def state_to_numpy(self, state: HaloStepState) -> dict:
        """The whole state in the reference's layout (numpy; None where
        absent): a collective, every rank calls it and gets it."""
        out = {
            k: None if getattr(state, k) is None else (
                self._owned_layout(getattr(state, k)) if k in _OWNED else getattr(state, k)
            ).cpu().numpy()
            for k in _STATE_ARRAYS
        }
        out["step"] = int(state.step)
        return out

    def init_state(self, state=None) -> HaloStepState:
        """The owned-layout state of a models.base State (or of the
        solver's initial state)."""
        if state is None:
            state = self.solver.initial_state()
        u_own = self.shard(state.u)
        keep_hist = self._bdf2 or self._extrap
        return HaloStepState(
            u=u_own, p=state.p.clone(), step=int(state.step),
            u_prev=u_own if keep_hist else None,
            u_prev2=u_own if self._quad else None,
            p_prev=state.p.clone() if self._extrap else None,
            spool=(torch.zeros((2, self._srec, self.solver.space.n_pnodes), dtype=self.dtype,
                               device=self.device) if self._srec > 0 else None),
        )

    # -- the step ------------------------------------------------------
    def __call__(self, state: HaloStepState):
        import torch.distributed as dist

        solver, cfg, plan, ex = self.solver, self.solver.config, self.plan, self.ex_u
        op, group = self.op_sh, self.group
        dt, nu = cfg.time.dt, solver.problem.nu
        n_loc, d = plan.u.n_loc, solver.space.dim
        E_d, nloc = plan.E_d, plan.u.cells_loc.shape[2]
        precise = cfg.numerics.precise_dots
        t_new = (state.step + 1.0) * dt
        # Dirichlet data: a node-space evaluation on every rank, then its
        # owned block
        g_loc = self.shard(solver._dirichlet_values(t_new))

        u, u_prev = state.u, state.u_prev
        if self._bdf2 and state.step > 0:
            w, hist, dt_eff = 2.0 * u - u_prev, (4.0 * u - u_prev) / (2.0 * dt), dt / 1.5
        else:
            w, hist, dt_eff = u, u / dt, dt
        if self._extrap:
            not_first = 1.0 if state.step > 0 else 0.0
            u_guess = u + not_first * (u - u_prev)
            p_guess = state.p + not_first * (state.p - state.p_prev)
            if self._quad:
                not_second = 1.0 if state.step > 1 else 0.0
                u_guess = u_guess + not_second * (u - 2.0 * u_prev + state.u_prev2)
        else:
            u_guess, p_guess = u, state.p
        mask2 = self.mask[:, None]
        detJ, GKd, Jinv = op.detJ, op.GKd, op.Jinv

        def elem(x_loc):  # owned block [n_loc, C] -> element view [E_d, nloc, C]
            return ex.gather_elem(ex.gather_ext(x_loc)).view(E_d, nloc, -1)

        # ---- rhs and warm residual: one gather, one dual reduce
        u0 = torch.where(mask2, g_loc, u_guess)
        st_e = elem(torch.cat([hist, u0, w], dim=1))
        h_e, u0_e, w_e = st_e[..., :d], st_e[..., d:2 * d], st_e[..., 2 * d:]
        p_e = state.p[self.cp_nat]  # the replicated pressure: a plain gather

        # convection tables at the quadrature points (cell-local)
        w_q = torch.einsum("qi,eic->eqc", op.PHI_U, w_e)
        wtilde = torch.einsum("ekd,eqd->eqk", Jinv, w_q)
        WG = torch.einsum("qik,eqk->eqi", op.GRAD_U, wtilde)
        gref = torch.einsum("qik,eic->eqkc", op.GRAD_U, w_e)
        divw = torch.einsum("eqkc,ekc->eq", gref, Jinv)

        def conv_term(v_e):
            v_q = torch.einsum("qi,eic->eqc", op.PHI_U, v_e)
            r = torch.einsum("eqi,eic->eqc", WG, v_e) + 0.5 * divw[:, :, None] * v_q
            return torch.einsum("q,qi,eqc->eic", op.W, op.PHI_U, r) * detJ[:, None, None]

        def K_term(v_e):
            y = torch.einsum("ij,ejc->eic", op.MHAT, v_e) * (detJ / dt_eff)[:, None, None]
            return y + nu * torch.einsum("ekl,klij,ejc->eic", GKd, op.AHAT, v_e)

        b_e = torch.einsum("ij,ejc->eic", op.MHAT, h_e) * detJ[:, None, None]
        b_e = b_e + torch.einsum("ekc,kij,ei->ejc", Jinv, op.BHAT, p_e) * detJ[:, None, None]
        f_e = K_term(u0_e) + conv_term(u0_e)
        y2 = ex.reduce_ext(torch.cat([b_e, b_e - f_e], dim=-1).reshape(-1, 2 * d))
        b_u, r0_u = y2[:, :d], y2[:, d:]
        rhs_u = torch.where(mask2, g_loc, b_u)
        r0 = torch.where(mask2, torch.zeros_like(r0_u), r0_u).reshape(-1)

        # ---- 1. tentative velocity: FGMRES with all-reduced dots
        bnorm = float(_cnorm(rhs_u.reshape(-1, 1), precise, group)[0])
        atol = max(cfg.solver.rtol * bnorm, cfg.solver.atol)

        def Fop(v):
            uv = v.reshape(n_loc, d)
            u_e = elem(uv)
            y = ex.reduce_ext((K_term(u_e) + conv_term(u_e)).reshape(-1, d))
            return torch.where(mask2, uv, y).reshape(-1)

        minv = self.invdiag[:, None].expand(n_loc, d).reshape(-1)
        du, info_f = fgmres(
            Fop, r0, M=lambda v: minv * v, rtol=0.0, atol=atol, tol_mode="abs",
            restart=cfg.solver.restart, maxiter=cfg.solver.maxiter, precise=precise, group=group,
        )
        u_star = u0 + du.reshape(n_loc, d)

        # ---- 2. pressure Poisson on the replicated pressure space
        us_e = elem(u_star)
        div_e = torch.einsum("ekc,kij,ejc->ei", Jinv, op.BHAT, us_e) * detJ[:, None]
        rhs_p = apply_segment_plan(self.plan_p, div_e.reshape(-1, 1))[:, 0]
        dist.all_reduce(rhs_p, group=group)
        rhs_p = -rhs_p / dt_eff  # S~ = dt_eff S1: the rescaled system

        fz = self.fz
        if fz.band is not None:
            def S(pv):
                return banded_matvec(fz.band, pv)
        else:
            def S(pv):
                return schur_ell_matvec(solver.op.schur, fz.vals1, pv)

        def M2(v):
            return twolevel_apply_additive_g(solver.op.coarse, self.solve_c, self.inv_d, v)

        rp_norm = float(_cnorm(rhs_p[:, None], precise)[0])
        s_atol = min(atol / dt_eff, cfg.solver.proj_div_cap * rp_norm)
        phi0 = p_guess - state.p if self._extrap else torch.zeros_like(state.p)
        spool = state.spool
        if spool is not None:
            phi, info_s, harv = cg_recycled(
                S, rhs_p, M2, phi0, spool[0], spool[1], rtol=0.0, atol=s_atol,
                maxiter=cfg.solver.maxiter, precise=precise,
            )
            spool = torch.cat([harv[:, None, :], spool[:, :-1]], dim=1)
        else:
            phi, info_s = cg(S, rhs_p, M=M2, x0=phi0, rtol=0.0, atol=s_atol,
                             maxiter=cfg.solver.maxiter, precise=precise)

        # ---- 3. update
        gphi_e = -torch.einsum("ekc,kij,ei->ejc", Jinv, op.BHAT, phi[self.cp_nat]) * detJ[:, None, None]
        gphi = ex.reduce_ext(gphi_e.reshape(-1, d))
        u_new = u_star - (dt_eff * self.inv1)[:, None] * gphi
        keep_hist = self._bdf2 or self._extrap
        new_state = HaloStepState(
            u=u_new, p=state.p + phi, step=state.step + 1,
            u_prev=state.u if keep_hist else None,
            u_prev2=state.u_prev if self._quad else None,
            p_prev=state.p if self._extrap else None,
            spool=spool,
        )
        return new_state, (int(info_f.iters), int(info_s.iters))

