"""Element-slot gather and reduce for channel-packed ensemble payloads.

The counterpart of the reference's `ops/onehot.py` (`build_onehot_plans`,
`onehot_gather`, `onehot_reduce`).  Both functions move a payload whose
channels pack every ensemble member (C = dim * B) between node rows and
element slots:

    gather:  y_e[s, :] = x[cells_flat[s], :]
    reduce:  out[n, :] = sum_{s: cells_flat[s] = n} y_e[s, :]

The reference computed them with windowed one-hot MXU products (and a
bf16 hi/lo split, accumulating in float32 for every payload dtype).  Here
the plans are a flat index for the gather and a CSR order by target row
(`ops/scatter.py build_segment_plan`) for the reduce, and each function is
exact in its dtype: on a CUDA tensor the hand-written kernels of
`csrc/ensemble_kernels.cu` (kernel D `slot_gather`, kernel C
`slot_reduce`), on a CPU tensor their plain PyTorch versions.
`launch_counts` counts the kernel launches only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.device import pick_device
from navierstokes_project_nm4pde_tpu_torch.ops import cuda_lib
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    SegmentPlan,
    apply_segment_plan,
    build_segment_plan,
)

launch_counts = {"slot_reduce": 0, "slot_gather": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class OneHotPlans:
    """Slot <-> row plans of one element table (indices validated at build)."""

    gather: torch.Tensor  # [n_slots] int64 row of each element slot
    reduce: SegmentPlan  # slots -> rows, CSR by target row
    n_rows: int
    n_slots: int


def build_onehot_plans(cells, n_rows: int, device=None) -> OneHotPlans:
    """Plans for the element table `cells` [E, n_loc] (any order; the sums
    run in slot order within each row), on `device` (None: the card)."""
    device = pick_device(device)
    flat = np.asarray(cells, dtype=np.int64).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= n_rows):
        raise ValueError(f"element table holds rows outside [0, {n_rows})")
    return OneHotPlans(
        gather=torch.as_tensor(flat, device=device),
        reduce=build_segment_plan(flat, n_rows, device=device),
        n_rows=n_rows,
        n_slots=int(flat.size),
    )


def _check_payload(name: str, t: torch.Tensor, rows: int, plans: OneHotPlans) -> None:
    if (
        t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous()
        or t.shape[0] != rows or plans.gather.device != t.device
    ):
        raise ValueError(
            f"{name}: expected a contiguous float32 [{rows}, C] tensor on the "
            f"plans' device {plans.gather.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )


# ----------------------------------------------------------------------
# Kernel D: slot gather
# ----------------------------------------------------------------------
def onehot_gather_plain(plans: OneHotPlans, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel D: [n_rows, C] -> [n_slots, C]."""
    return x.index_select(0, plans.gather)


def onehot_gather(plans: OneHotPlans, x: torch.Tensor) -> torch.Tensor:
    """y_e = x[cells_flat] for a payload x [n_rows, C] (kernel D)."""
    if x.device.type == "cpu":
        return onehot_gather_plain(plans, x)
    if x.device.type != "cuda":
        raise ValueError(f"onehot_gather: unsupported device {x.device}")
    _check_payload("onehot_gather", x, plans.n_rows, plans)
    lib = cuda_lib.load()
    C = x.shape[1]
    y = torch.empty((plans.n_slots, C), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_lib.check(
        lib.ns_slot_gather_f32(
            x.data_ptr(), plans.gather.data_ptr(), y.data_ptr(), plans.n_slots, C,
            stream,
        ),
        "onehot_gather",
    )
    launch_counts["slot_gather"] += 1
    return y


# ----------------------------------------------------------------------
# Kernel C: slot reduce
# ----------------------------------------------------------------------
def onehot_reduce_plain(plans: OneHotPlans, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel C: [n_slots, C] -> [n_rows, C] (a permuted copy,
    then a segmented sum)."""
    return apply_segment_plan(plans.reduce, y)


def onehot_reduce(plans: OneHotPlans, y: torch.Tensor) -> torch.Tensor:
    """out[n] = sum of y over the slots of row n, y [n_slots, C] (kernel C)."""
    if y.device.type == "cpu":
        return onehot_reduce_plain(plans, y)
    if y.device.type != "cuda":
        raise ValueError(f"onehot_reduce: unsupported device {y.device}")
    _check_payload("onehot_reduce", y, plans.n_slots, plans)
    lib = cuda_lib.load()
    C = y.shape[1]
    out = torch.empty((plans.n_rows, C), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    cuda_lib.check(
        lib.ns_slot_reduce_f32(
            y.data_ptr(), plans.reduce.perm.data_ptr(),
            plans.reduce.offsets.data_ptr(), out.data_ptr(), plans.n_rows, C,
            stream,
        ),
        "onehot_reduce",
    )
    launch_counts["slot_reduce"] += 1
    return out
