"""Assembly reductions as a setup-time CSR plan plus a segmented sum.

The counterpart of the reference's `ops/scatter.py` (`build_gather_plan`,
`build_gather_plan_grouped`, `apply_gather_plan`, `build_inverse_map`,
`apply_inverse_map`).  The semantics are the same: a flat array of
element-local contributions [n_slots, ...] is summed into [n_rows, ...]
rows, optionally discarding every slot that targets `drop_row`.

The reference recast the scatter-add as padded gathers bucketed by valence
(and windowed / halving variants) because XLA's TPU scatter is serialised.
On the GPU a direct form is fine: at setup the kept slots are sorted by
target row (stable, so each row sums its slots in slot order) and each
apply is one gather into that order plus `torch.segment_reduce`.  The
segmented sum walks each row's run in one thread, so unlike `index_add_`
(atomics) it is deterministic and iteration counts repeat run to run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.device import pick_device


@dataclasses.dataclass
class SegmentPlan:
    """CSR form of a slot -> row reduction."""

    perm: torch.Tensor  # [n_kept] int64 slot ids sorted by target row
    lengths: torch.Tensor  # [n_rows] int64 slots per row
    offsets: torch.Tensor  # [n_rows + 1] int64 start of each row's run in perm
    n_slots: int
    n_rows: int


def build_segment_plan(
    flat, n_rows: int, drop_row: int | None = None, device=None
) -> SegmentPlan:
    """Plan reducing slot i into row `flat[i]` (slots with
    `flat[i] == drop_row` are discarded), on `device` (None: the card)."""
    device = pick_device(device)
    flat = np.asarray(flat).reshape(-1).astype(np.int64)
    n_slots = flat.shape[0]
    pos = np.arange(n_slots, dtype=np.int64)
    if drop_row is not None:
        keep = flat != drop_row
        pos, flat = pos[keep], flat[keep]
    order = np.argsort(flat, kind="stable")
    lengths = np.bincount(flat, minlength=n_rows)
    if lengths.shape[0] != n_rows:
        raise ValueError(f"slot targets exceed n_rows={n_rows}")
    return SegmentPlan(
        perm=torch.as_tensor(pos[order], device=device),
        lengths=torch.as_tensor(lengths, device=device),
        offsets=torch.as_tensor(
            np.concatenate([[0], np.cumsum(lengths)]), device=device
        ),
        n_slots=n_slots,
        n_rows=n_rows,
    )


def apply_segment_plan(plan: SegmentPlan, flat: torch.Tensor) -> torch.Tensor:
    """Reduce contributions [n_slots, ...] -> [n_rows, ...]."""
    if flat.shape[0] != plan.n_slots:
        raise ValueError(
            f"expected {plan.n_slots} slot rows, got {flat.shape[0]}"
        )
    return torch.segment_reduce(
        flat.index_select(0, plan.perm), "sum", lengths=plan.lengths,
        axis=0, unsafe=True,
    )


@dataclasses.dataclass
class InverseMap:
    """Gather form of `out[idx] = vals` with a zero pad row (Dirichlet
    value injection)."""

    inv: torch.Tensor  # [n_rows] int64 into the concatenated values (+ pad)


def build_inverse_map(index_groups, n_rows: int, device=None) -> InverseMap:
    """`index_groups`: int arrays whose concatenation is unique.  Rows not
    covered map to the pad slot after the last value.  On `device` (None:
    the card)."""
    device = pick_device(device)
    inv = np.full(n_rows, -1, dtype=np.int64)
    off = 0
    for g in index_groups:
        g = np.asarray(g)
        inv[g] = off + np.arange(len(g))
        off += len(g)
    inv[inv < 0] = off
    return InverseMap(inv=torch.as_tensor(inv, device=device))


def apply_inverse_map(m: InverseMap, values: torch.Tensor, fill=0.0) -> torch.Tensor:
    pad = torch.full(
        (1,) + tuple(values.shape[1:]), fill, dtype=values.dtype,
        device=values.device,
    )
    return torch.cat([values, pad], dim=0).index_select(0, m.inv)
