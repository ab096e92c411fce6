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
`slot_reduce`; float32 or float64, each in its own type), on a CPU tensor
their plain PyTorch versions.

Between the two sits the ensemble's per-member element product,
`member_product` (kernel G, `csrc/element_kernels.cu`):

    y_e[e, i, c, b] = sum_j F_e[j, e, i, b] x_e[e, j, c, b]

from an element view x_e, or from node rows with kernel D's gather fused
in.  `launch_counts` counts the kernel launches only, by entry point:
float32's under the kernel's name, float64's under the name with `_f64`.
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

launch_counts = {
    "slot_reduce": 0, "slot_gather": 0, "slot_reduce_f64": 0, "slot_gather_f64": 0,
    "member_product": 0, "member_product_f64": 0,
}


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


def _check_payload(name: str, t: torch.Tensor, rows: int, plans: OneHotPlans) -> str:
    """The payload's entry-point suffix; raises for what the kernels do not
    take (any dtype but float32 and float64)."""
    if (
        t.dtype not in cuda_lib.SUFFIX or t.dim() != 2 or not t.is_contiguous()
        or t.shape[0] != rows or plans.gather.device != t.device
    ):
        raise ValueError(
            f"{name}: expected a contiguous float32 or float64 [{rows}, C] "
            f"tensor on the plans' device {plans.gather.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    return cuda_lib.SUFFIX[t.dtype]


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
    entry = f"ns_slot_gather_{_check_payload('onehot_gather', x, plans.n_rows, plans)}"
    C = x.shape[1]
    y = torch.empty((plans.n_slots, C), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_lib.check(
        getattr(cuda_lib.load(), entry)(
            x.data_ptr(), plans.gather.data_ptr(), y.data_ptr(), plans.n_slots, C, stream,
        ),
        entry,
    )
    launch_counts[cuda_lib.count_key("slot_gather", x.dtype)] += 1
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
    entry = f"ns_slot_reduce_{_check_payload('onehot_reduce', y, plans.n_slots, plans)}"
    C = y.shape[1]
    out = torch.empty((plans.n_rows, C), dtype=y.dtype, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    cuda_lib.check(
        getattr(cuda_lib.load(), entry)(
            y.data_ptr(), plans.reduce.perm.data_ptr(), plans.reduce.offsets.data_ptr(),
            out.data_ptr(), plans.n_rows, C, stream,
        ),
        entry,
    )
    launch_counts[cuda_lib.count_key("slot_reduce", y.dtype)] += 1
    return out


# ----------------------------------------------------------------------
# Kernel G: per-member element product
# ----------------------------------------------------------------------
def member_product_plain(F_e: torch.Tensor, x_e: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel G: nloc fused multiply-adds into one [E, i, c, B]
    accumulator, each streaming one contiguous [E, i, B] slab of F_e (no
    [B, E, i, j, c] intermediate; cuBLAS's batched GEMM over the 612,864
    tiny (member, cell) products of the 64-member ensemble took 3.9 ms an
    apply on an H100, this chain 0.74 ms)."""
    y = F_e[0][:, :, None, :] * x_e[:, 0][:, None, :, :]
    for j in range(1, F_e.shape[0]):
        y.addcmul_(F_e[j][:, :, None, :], x_e[:, j][:, None, :, :])
    return y


def member_product(F_e: torch.Tensor, x: torch.Tensor, plans: OneHotPlans | None = None) -> torch.Tensor:
    """y_e [E, nloc, C, B] = sum_j F_e[j, e, i, b] x_e[e, j, c, b] for the
    per-member element matrices F_e [nloc, E, nloc, B] (kernel G).  `x` is
    the element view x_e [E, nloc, C, B], any strides; with `plans` it is
    the node rows u [n_rows, C, B], whose element view the kernel gathers
    as it reads (kernel D's gather fused in)."""
    nloc, E, _, B = F_e.shape
    if x.device.type == "cpu":
        if plans is not None:
            x = onehot_gather_plain(plans, x.reshape(x.shape[0], -1)).view(E, nloc, *x.shape[1:])
        return member_product_plain(F_e, x)
    if x.device.type != "cuda":
        raise ValueError(f"member_product: unsupported device {x.device}")
    rows = (plans.n_rows,) if plans is not None else (E, nloc)
    if (
        F_e.dtype not in cuda_lib.SUFFIX or x.dtype != F_e.dtype or not F_e.is_contiguous()
        or F_e.shape[2] != nloc or nloc not in (6, 10) or F_e.device != x.device
        or x.dim() != len(rows) + 2 or tuple(x.shape[:len(rows)]) != rows or x.shape[-1] != B
        or (plans is not None and (plans.n_slots != E * nloc or plans.gather.device != x.device))
    ):
        layout = "[n_rows, C, B] on the plans' rows" if plans is not None else "[E, nloc, C, B]"
        raise ValueError(
            f"member_product: expected a contiguous float32 or float64 F_e [nloc, E, nloc, B] "
            f"(nloc 6 or 10) and x {layout} of its type and device; got F_e {F_e.dtype} "
            f"{tuple(F_e.shape)} on {F_e.device}, x {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    C = x.shape[-2]
    if plans is not None:
        cells, s_e, (s_j, s_c, s_b) = plans.gather.data_ptr(), 0, x.stride()
    else:
        cells, (s_e, s_j, s_c, s_b) = None, x.stride()
    y = torch.empty((E, nloc, C, B), dtype=x.dtype, device=x.device)
    entry = f"ns_member_product_{cuda_lib.SUFFIX[x.dtype]}"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_lib.check(
        getattr(cuda_lib.load(), entry)(
            F_e.data_ptr(), x.data_ptr(), cells, y.data_ptr(), E, nloc, C, B,
            s_e, s_j, s_c, s_b, stream,
        ),
        entry,
    )
    launch_counts[cuda_lib.count_key("member_product", x.dtype)] += 1
    return y
