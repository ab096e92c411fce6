"""Owned+halo operator application: each rank holds its own block of the
node vectors and exchanges only the halo slabs.

The counterpart of the reference's `parallel/halo.py` (the reference's
owned/ghost IndexSet model; ref: src/NavierStokes2D.cpp:71-87 owned and
relevant DoFs, :315-320 compress()).  The cell-sharded path
(`parallel/sharding.py`) replicates node vectors and all-reduces a full
vector per element pass; here node vectors are block-partitioned in their
spatial order, aligned with the cell blocks, so that a rank's cells touch
almost only its own nodes plus thin slabs owned by other ranks:

  * `build_halo_plan` (numpy, set-up): the ownership permutation, each
    rank's ghost slabs per ring shift and its extended-local connectivity;
    the arrays equal the reference's exactly (the per-slot loop that
    remaps the cells is vectorised here), and the reference's local reduce
    table is the slot plan of that connectivity (kernel C sums each row's
    slots in the table's order);
  * `HaloExchange` (one rank's side of one node space): the forward halo
    (ghost rows from their owners) and the reverse halo (the ghost rows'
    assembly contributions back to their owners) as point-to-point
    exchanges of the slabs, over NCCL when each rank has its own card and
    staged through host memory under gloo; the element gather from the
    extended layout runs through kernel D and the local gather-sum into it
    through kernel C, on a slot plan of the rank's `cells_loc`;
  * `halo_apply_system`: the saddle-point operator on owned blocks;
  * `collective_bytes_per_apply`: the exchanged volume against the
    replicated path's all-reduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
from navierstokes_project_nm4pde_tpu_torch.ops.onehot import (
    build_onehot_plans,
    onehot_gather,
    onehot_reduce,
)


@dataclasses.dataclass
class HaloSide:
    """Halo structure of one node space (velocity or pressure nodes), for
    every rank (host arrays; the reference's fields and values)."""

    # extended-local connectivity: owned rows [0, n_loc), then each shift's
    # ghost slab
    cells_loc: np.ndarray  # [n_dev, E_d, nloc] int64
    # per shift: the rows each rank sends to the rank `shift` places behind
    # it (local ids in the sender's block; padding rows 0)
    send: tuple  # of [n_dev, H_s] int64
    # natural row id -> owned-layout position in [0, n_dev * n_loc)
    perm: np.ndarray  # [n_rows] int64
    n_loc: int
    n_ext: int
    shifts: tuple
    halo_sizes: tuple
    n_slots: int
    n_rows: int


@dataclasses.dataclass
class HaloPlan:
    u: HaloSide
    p: HaloSide
    n_dev: int
    E_d: int


def _ownership_perm(n_rows: int, n_dev: int, splits: tuple):
    """Permutation natural-id -> block-owned layout, splitting every
    sub-space (e.g. P2 vertices / first-touch edges) into n_dev contiguous
    blocks; device d owns one block of each.  Returns (perm, n_loc)."""
    bounds = (0,) + tuple(splits) + (n_rows,)
    seg_loc = [-(-(bounds[i + 1] - bounds[i]) // n_dev) for i in range(len(bounds) - 1)]
    n_loc = sum(seg_loc)
    seg_base = np.concatenate([[0], np.cumsum(seg_loc)[:-1]])
    perm = np.empty(n_rows, dtype=np.int64)
    for i in range(len(bounds) - 1):
        lo, hi, sl = bounds[i], bounds[i + 1], seg_loc[i]
        ids = np.arange(lo, hi)
        perm[ids] = (ids - lo) // sl * n_loc + seg_base[i] + (ids - lo) % sl
    return perm, n_loc


def _build_side(cells: np.ndarray, n_rows: int, n_dev: int, splits: tuple = ()) -> HaloSide:
    """Halo structure of one node space from [E_pad, nloc] connectivity
    (E_pad a multiple of n_dev; padding cells reference row 0)."""
    E_pad, nloc = cells.shape
    E_d = E_pad // n_dev
    perm, n_loc = _ownership_perm(n_rows, n_dev, splits)
    blocks = perm[cells].reshape(n_dev, E_d, nloc)  # in the owned layout throughout
    owner_b = blocks // n_loc

    ghost_ids = {}  # (d, s) -> sorted unique global ids of d's shift-s ghosts
    for d in range(n_dev):
        g, sh = blocks[d].reshape(-1), (owner_b[d].reshape(-1) - d) % n_dev
        for s in np.unique(sh):
            if s:
                ghost_ids[(d, int(s))] = np.unique(g[sh == s])
    shifts = tuple(sorted({s for _, s in ghost_ids}))
    halo_sizes = tuple(max(len(ghost_ids.get((d, s), ())) for d in range(n_dev)) for s in shifts)

    # device o sends to (o - s) % n_dev the rows that device needs from o
    send = []
    for s, H in zip(shifts, halo_sizes):
        tab = np.zeros((n_dev, H), dtype=np.int64)
        for o in range(n_dev):
            want = ghost_ids.get(((o - s) % n_dev, s), np.zeros(0, np.int64))
            tab[o, : len(want)] = want - o * n_loc
        send.append(tab)

    # extended-local connectivity: a ghost's position is its slab's offset
    # plus its rank in the slab
    offs = np.concatenate([[0], np.cumsum(halo_sizes)[:-1]]).astype(np.int64) + n_loc
    n_ext = n_loc + int(sum(halo_sizes))
    cells_loc = np.empty_like(blocks)
    for d in range(n_dev):
        flat = blocks[d].reshape(-1)
        own = flat // n_loc == d
        loc = np.where(own, flat - d * n_loc, 0)
        parts = [(ghost_ids[(d, s)], offs[i]) for i, s in enumerate(shifts) if (d, s) in ghost_ids]
        if parts:
            gid = np.concatenate([ids for ids, _ in parts])
            gpos = np.concatenate([o + np.arange(len(ids)) for ids, o in parts])
            order = np.argsort(gid, kind="stable")
            loc[~own] = gpos[order][np.searchsorted(gid[order], flat[~own])]
        cells_loc[d] = loc.reshape(E_d, nloc)

    return HaloSide(
        cells_loc=cells_loc, send=tuple(send), perm=perm, n_loc=n_loc, n_ext=n_ext,
        shifts=shifts, halo_sizes=halo_sizes, n_slots=E_d * nloc, n_rows=n_rows,
    )


def build_halo_plan(op: ops.NSOperator, n_dev: int, n_vertices: int | None = None) -> HaloPlan:
    """From a cell-padded operator (`sharding._pad_cells`).  `n_vertices`
    splits the P2 velocity space into its vertex and edge sub-spaces, each
    block-partitioned on its own (both follow the cells' spatial order)."""
    cells_u = op.cells_u.cpu().numpy()
    cells_p = op.cells_p.cpu().numpy()
    if cells_u.shape[0] % n_dev:
        raise ValueError("pad the cells to a multiple of n_dev first (sharding._pad_cells)")
    return HaloPlan(
        u=_build_side(cells_u, op.n_unodes, n_dev, splits=(n_vertices,) if n_vertices else ()),
        p=_build_side(cells_p, op.n_pnodes, n_dev),
        n_dev=n_dev,
        E_d=cells_u.shape[0] // n_dev,
    )


def owned_block(side: HaloSide, x, rank: int) -> np.ndarray:
    """Rank `rank`'s owned block [n_loc, ...] of a natural-order array x
    [n_rows, ...] (rows past n_rows are zero padding)."""
    x = np.asarray(x)
    full = np.zeros((side.cells_loc.shape[0] * side.n_loc,) + x.shape[1:], x.dtype)
    full[side.perm] = x
    return full[rank * side.n_loc:(rank + 1) * side.n_loc]


def to_natural(side: HaloSide, y_owned) -> np.ndarray:
    """Owned layout (all ranks' blocks in rank order) -> natural row order."""
    return np.asarray(y_owned)[side.perm]


class HaloExchange:
    """One rank's side of a HaloSide on its device: the slot plan of its
    extended-local cells (kernels D and C), its send rows, and the forward
    and reverse slab exchanges over `group`.  `bytes_sent` counts the
    payload this rank has sent."""

    def __init__(self, side: HaloSide, group, device):
        import torch.distributed as dist

        self.side = side
        self.group = group
        self.rank, self.n = dist.get_rank(group), dist.get_world_size(group)
        self.device = torch.device(device)
        self.plans = build_onehot_plans(side.cells_loc[self.rank], side.n_ext, device=self.device)
        self.send = [torch.as_tensor(t[self.rank], device=self.device) for t in side.send]
        self.backend = dist.get_backend(group)
        # gloo moves no CUDA tensor point to point: stage through the host
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.bytes_sent = 0

    def _swap(self, out: torch.Tensor, to: int, frm: int, rows: int) -> torch.Tensor:
        """Send `out` to rank `to` and receive a slab of `rows` rows from
        rank `frm` (group ranks)."""
        import torch.distributed as dist

        stage = torch.device("cpu") if self.staged else self.device
        out = out.to(stage).contiguous()
        buf = torch.empty((rows,) + tuple(out.shape[1:]), dtype=out.dtype, device=stage)
        ranks = dist.get_process_group_ranks(self.group)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, ranks[to], self.group),
            dist.P2POp(dist.irecv, buf, ranks[frm], self.group),
        ])
        for q in reqs:
            q.wait()
        self.bytes_sent += out.numel() * out.element_size()
        return buf.to(self.device)

    def gather_ext(self, x_loc: torch.Tensor) -> torch.Tensor:
        """Owned block [n_loc, C] -> extended block [n_ext, C]: rank r
        receives its shift-s ghost slab from rank (r + s) % n."""
        slabs = [x_loc]
        for i, s in enumerate(self.side.shifts):
            slabs.append(self._swap(x_loc[self.send[i]], (self.rank - s) % self.n,
                                    (self.rank + s) % self.n, self.side.halo_sizes[i]))
        return torch.cat(slabs)

    def gather_elem(self, x_ext: torch.Tensor) -> torch.Tensor:
        """Extended block [n_ext, C] -> element slots [E_d * nloc, C] (kernel D)."""
        return onehot_gather(self.plans, x_ext.contiguous())

    def reduce_ext(self, y: torch.Tensor) -> torch.Tensor:
        """Slot contributions [E_d * nloc, C] -> owned rows [n_loc, C]: the
        local gather-sum into the extended layout (kernel C), then each
        ghost slab's sums back to its owner, added into the owner's rows."""
        y_ext = onehot_reduce(self.plans, y.contiguous())
        y_own = y_ext[: self.side.n_loc].clone()
        off = self.side.n_loc
        for i, s in enumerate(self.side.shifts):
            H = self.side.halo_sizes[i]
            slab = self._swap(y_ext[off:off + H], (self.rank + s) % self.n, (self.rank - s) % self.n, H)
            y_own.index_add_(0, self.send[i], slab)
            off += H
        return y_own


def halo_apply_system(
    op: ops.NSOperator, plan: HaloPlan, group, nu, dt, conv: ops.ConvectionData | None,
    u_loc: torch.Tensor, p_loc: torch.Tensor, exchanges: tuple | None = None,
):
    """(y_u, y_p) = K [u; p] on this rank's owned blocks u_loc [n_loc_u,
    dim] and p_loc [n_loc_p] (`owned_block`), equal to
    `ops.apply_system(..., mask_rows=False)` on those rows.  `op` is the
    rank's cell-sharded operator (`sharding.shard_operator`) and `conv`,
    if any, its cells' convection tables.  `exchanges` = (velocity,
    pressure) HaloExchange, built here when None."""
    exu, exp = exchanges or (HaloExchange(plan.u, group, u_loc.device), HaloExchange(plan.p, group, u_loc.device))
    E_d, nloc = plan.E_d, plan.u.cells_loc.shape[2]
    d = u_loc.shape[1]
    u_e = exu.gather_elem(exu.gather_ext(u_loc)).view(E_d, nloc, d)
    p_e = exp.gather_elem(exp.gather_ext(p_loc[:, None])).view(E_d, -1)
    detJ = op.detJ
    y_e = torch.einsum("ij,ejc->eic", op.MHAT, u_e) * (detJ / dt)[:, None, None]
    y_e = y_e + nu * torch.einsum("ekl,klij,ejc->eic", op.GKd, op.AHAT, u_e)
    if conv is not None:
        u_q = torch.einsum("qi,eic->eqc", op.PHI_U, u_e)
        r = torch.einsum("eqi,eic->eqc", conv.WG, u_e) + 0.5 * conv.divw[:, :, None] * u_q
        y_e = y_e + torch.einsum("q,qi,eqc->eic", op.W, op.PHI_U, r) * detJ[:, None, None]
    # the pressure gradient rides the same velocity reduction
    y_e = y_e - torch.einsum("ekc,kij,ei->ejc", op.Jinv, op.BHAT, p_e) * detJ[:, None, None]
    y_u = exu.reduce_ext(y_e.reshape(-1, d))
    y_pe = torch.einsum("ekc,kij,ejc->ei", op.Jinv, op.BHAT, u_e) * detJ[:, None]
    y_p = exp.reduce_ext(y_pe.reshape(-1, 1))[:, 0]
    return y_u, y_p


def collective_bytes_per_apply(plan: HaloPlan, dim: int, itemsize: int = 4) -> dict:
    """Cross-rank traffic of one halo_apply_system against the replicated
    path: per shift, every rank sends one slab forward (gather) and one back
    (assembly) for each node space; the replicated path all-reduces the full
    [n_u, dim] + [n_p] outputs (a ring all-reduce moves about twice the
    payload a rank)."""
    halo = sum(2 * plan.n_dev * H * dim * itemsize for H in plan.u.halo_sizes)
    halo += sum(2 * plan.n_dev * H * itemsize for H in plan.p.halo_sizes)
    repl = 2 * (plan.u.n_rows * dim + plan.p.n_rows) * itemsize * plan.n_dev
    return {
        "halo_bytes_total": halo,
        "halo_bytes_per_device": halo // plan.n_dev,
        "replicated_allreduce_bytes_total": repl,
        "ratio": halo / max(repl, 1),
    }
