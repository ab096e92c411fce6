"""Cell-sharded runs: the element batch split over the ranks of a group,
the node vectors replicated.

The counterpart of the reference's `parallel/sharding.py`.  The reference
shards the element axis over a `jax.sharding.Mesh` and lets GSPMD place
the all-reduce after every assembly; here each rank (`parallel/launch.py`)
keeps its own contiguous block of the cells (and its own slot plans) and
runs the whole solver on replicated node vectors, and every node reduce
of an element pass all-reduces the rank's partial vector over the group
(`ops/operators.py` `scatter_u` / `scatter_p` when the operator carries
the group: the reference's compress()).  Everything node-space assembled
(the macro blocks, the assembled K and IMEX fine subset, the assembled D
and G) is dropped, as the reference drops it, so the step takes the
element fold; the frozen Schur, the coarse solves and every Krylov
vector are replicated, and every rank reads the same all-reduced values,
so the ranks take the same branches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.ops.operators import NSOperator
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import build_segment_plan


def make_device_mesh(n_devices: int | None = None):
    """The process group of the first `n_devices` ranks of the default
    group (all of them: None); torch.distributed must be initialised (see
    `parallel/launch.py`)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices asked for, {world} ranks in the default group")
    return dist.group.WORLD if n == world else dist.new_group(list(range(n)))


def _pad(x: torch.Tensor, rem: int, zero: bool) -> torch.Tensor:
    """x with `rem` copies of its row 0 appended (zeroed with `zero`)."""
    row = x[:1] * 0 if zero else x[:1]
    return torch.cat([x, row.expand(rem, *x.shape[1:])], dim=0)


def _pad_cells(op: NSOperator, multiple: int) -> NSOperator:
    """The operator with its element batch padded to a multiple of
    `multiple`: degenerate copies of cell 0 with detJ = 0 (and GKd = 0), so
    they add nothing to any integral."""
    E = op.cells_u.shape[0]
    rem = (-E) % multiple
    if rem == 0:
        return op
    cells_p = _pad(op.cells_p, rem, False)
    extra = {}
    if op.imex_scale is not None:
        extra["imex_scale"] = _pad(op.imex_scale, rem, False)
    return dataclasses.replace(
        op,
        cells_u=_pad(op.cells_u, rem, False),
        cells_p=cells_p,
        plan_p=build_segment_plan(cells_p.cpu().numpy(), op.n_pnodes, device=op.cells_u.device),
        detJ=_pad(op.detJ, rem, True),
        Jinv=_pad(op.Jinv, rem, False),
        GKd=_pad(op.GKd, rem, True),
        **extra,
    )


def _rank_block(n_cells_padded: int, group) -> slice:
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    blk = n_cells_padded // n
    return slice(r * blk, (r + 1) * blk)


def shard_operator(op: NSOperator, group) -> NSOperator:
    """This rank's block of the (padded) cells, with its own slot plans,
    element D and G, and `group` for the node reduces' all-reduce."""
    import torch.distributed as dist

    pad = _pad_cells(op, dist.get_world_size(group))
    sl = _rank_block(pad.cells_u.shape[0], group)
    cells_p = pad.cells_p[sl].contiguous()
    extra = {}
    if pad.imex_scale is not None:
        extra["imex_scale"] = pad.imex_scale[sl].contiguous()
    return dataclasses.replace(
        pad,
        cells_u=pad.cells_u[sl].contiguous(),
        cells_p=cells_p,
        plan_p=build_segment_plan(cells_p.cpu().numpy(), op.n_pnodes, device=op.cells_u.device),
        detJ=pad.detJ[sl].contiguous(),
        Jinv=pad.Jinv[sl].contiguous(),
        GKd=pad.GKd[sl].contiguous(),
        # the assembled D and G are node-space forms: element passes instead
        div=None,
        grad=None,
        group=group,
        **extra,
    )


def shard_solver(solver, group):
    """Shard a NavierStokesSolver's operator in place over `group` (this
    rank's cell block); drop the node-space assembled paths (the macro
    blocks, the assembled K and IMEX fine subset), so that the step takes
    the element fold, and give the forcing's cell quadrature the same
    block.  Returns the solver."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    E = solver.op.cells_u.shape[0]
    solver.op = shard_operator(solver.op, group)
    solver.kcsr = None
    solver.imex = None
    solver.f_apply = "element"
    solver.macro_rhs = solver.macro_wfuse = solver.macro_split = False
    solver.aux_div = True  # the element FGMRES's gathers give D u*, as the reference's
    if solver.ftab is not None:
        ft, rem = solver.ftab, (-E) % n
        sl = _rank_block(E + rem, group)
        solver.ftab = dataclasses.replace(
            ft, cells_u=_pad(ft.cells_u, rem, False)[sl], Jinv=_pad(ft.Jinv, rem, False)[sl],
            jxw=_pad(ft.jxw, rem, True)[sl], qpoints=_pad(ft.qpoints, rem, False)[sl],
        )
    return solver


def cell_partitioning(solver, group) -> np.ndarray:
    """Each cell's owning rank in the sharded element batch (the VTU
    `partitioning` field, the reference's subdomain output;
    ref: src/NavierStokes2D.cpp:662-665): contiguous blocks of the padded
    cell axis."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    E = solver.mesh.n_cells
    block = (E + (-E) % n) // n
    return np.arange(E) // block
