"""Macro-element block-dense form of the per-step velocity operator F.

The counterpart of the reference's `ops/macroblock.py`.  RCM-consecutive
cells are grouped into macro blocks of `c_blk` cells whose unique P2 nodes
fit in U slots; each step the folded element matrices F_e are summed into
one dense [U, U] block per macro block (kernel B, `macro_build`), and each
Krylov apply is a slot gather, a batched block matvec (kernel A,
`macro_matvec`) and a node reduce (`ops/scatter.py`).  Same operator as the
element apply `ops.operators.apply_F`, summed in another order.

Block values are kept transposed, FtT[b, v, u] = Ft[b, u, v] (the
reference's "vu" layout), which both kernels read and write coalesced.

Each kernel wrapper runs the CUDA kernel for CUDA tensors (or raises) and
its plain PyTorch version for CPU tensors; `launch_counts` counts the
kernel launches only.
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

# Shared memory a Hopper CTA may use (bytes); kernel B holds two [U, U] f32
# tiles and two stages of a block's inputs, its earlier design one tile.
_MAX_SMEM = 232_448

launch_counts = {"macro_build": 0, "macro_matvec": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class MacroPlan:
    """Static block structure (values are rebuilt per step)."""

    uidx: torch.Tensor  # [B, U] int64 global node of each block slot (pad -> n)
    lidx: torch.Tensor  # [B, c_blk, nloc] int32 block slot of each cell node
    elem_slot: torch.Tensor  # [E, nloc] int64 flat slot b*U + lidx of real cells
    plan: SegmentPlan  # flat [B*U] slot contributions -> [n] (pad slots dropped)
    n: int
    B: int
    U: int
    c_blk: int
    E: int


def build_macro_plan(
    cells_u: np.ndarray, n_unodes: int, U: int = 128, c_blk: int = 20,
    device=None,
) -> MacroPlan:
    """Group RCM-consecutive cells into blocks of `c_blk` with <= U unique
    nodes each (c_blk shrinks by 2 until every block fits).  The last
    block's padding cells repeat node cells[0, 0] and carry F_e = 0.  The
    plan lives on `device` (None: the card)."""
    device = pick_device(device)
    cells = np.asarray(cells_u, dtype=np.int64)
    E, nloc = cells.shape
    while c_blk > 1:
        B = -(-E // c_blk)
        pad = B * c_blk - E
        cp = np.concatenate(
            [cells, np.full((pad, nloc), cells[0, 0], np.int64)], axis=0
        ).reshape(B, c_blk, nloc)
        uidx = np.full((B, U), n_unodes, np.int64)
        lidx = np.empty((B, c_blk, nloc), np.int64)
        ok = True
        for b in range(B):
            uniq, inv = np.unique(cp[b], return_inverse=True)
            if len(uniq) > U:
                ok = False
                break
            uidx[b, : len(uniq)] = uniq
            lidx[b] = inv.reshape(c_blk, nloc)
        if ok:
            break
        c_blk -= 2
    else:
        raise ValueError("macro blocks cannot satisfy U even at c_blk=2")

    elem_slot = (
        np.arange(B, dtype=np.int64)[:, None, None] * U + lidx
    ).reshape(B * c_blk, nloc)[:E]
    return MacroPlan(
        uidx=torch.as_tensor(uidx, device=device),
        lidx=torch.as_tensor(lidx.astype(np.int32), device=device),
        elem_slot=torch.as_tensor(elem_slot, device=device),
        plan=build_segment_plan(
            uidx.reshape(-1), n_unodes, drop_row=n_unodes, device=device
        ),
        n=n_unodes,
        B=B,
        U=U,
        c_blk=c_blk,
        E=E,
    )


# ----------------------------------------------------------------------
# Kernel B: block value build
# ----------------------------------------------------------------------
def macro_build_plain(
    F_e: torch.Tensor, lidx: torch.Tensor, B: int, U: int
) -> torch.Tensor:
    """Plain PyTorch kernel B: FtT[b, lidx[c, j], lidx[c, i]] += F_e[c, i, j]
    summed over the block's cells (padding cells past E add zero)."""
    E, nloc, _ = F_e.shape
    c_blk = lidx.shape[1]
    F_ep = F_e.new_zeros((B * c_blk, nloc, nloc))
    F_ep[:E] = F_e
    li = lidx.to(torch.int64)
    base = torch.arange(B, device=F_e.device).view(B, 1, 1, 1) * (U * U)
    flat = base + li[:, :, None, :] * U + li[:, :, :, None]  # [B, c, i, j]
    out = F_e.new_zeros(B * U * U)
    out.index_add_(0, flat.reshape(-1), F_ep.reshape(-1))
    return out.view(B, U, U)


def _check_build_args(name: str, F_e: torch.Tensor, lidx: torch.Tensor, B: int, U: int) -> None:
    """Raise ValueError for inputs kernel B (either design) does not take."""
    if F_e.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {F_e.device}")
    E, nloc, nloc2 = F_e.shape
    if F_e.dtype != torch.float32 or not F_e.is_contiguous() or nloc2 != nloc:
        raise ValueError(
            f"{name}: F_e must be a contiguous float32 [E, nloc, nloc] "
            f"tensor, got {F_e.dtype} {tuple(F_e.shape)}"
        )
    if (
        lidx.dtype != torch.int32 or not lidx.is_contiguous()
        or lidx.device != F_e.device or lidx.dim() != 3
        or lidx.shape[0] != B or lidx.shape[2] != nloc
    ):
        raise ValueError(
            f"{name}: lidx must be a contiguous int32 [B, c_blk, nloc] "
            "tensor on F_e's device"
        )
    c_blk = lidx.shape[1]
    if not (B - 1) * c_blk < E <= B * c_blk:
        raise ValueError(f"{name}: E={E} does not fill B={B} blocks of {c_blk}")
    _check_slots(name, lidx, U)


def _check_slots(name: str, lidx: torch.Tensor, U: int) -> None:
    """Raise ValueError if lidx holds a slot outside [0, U).  The check
    reads the table back to the host, so the table keeps a mark of it
    (its version and U): a plan's table is checked once, not every step,
    and again after an in-place write."""
    mark = (lidx._version, U)
    if getattr(lidx, "_slots_checked", None) == mark:
        return
    lo, hi = (int(v) for v in torch.aminmax(lidx))
    if lo < 0 or hi >= U:
        # the kernel adds at these slots in shared memory, unchecked
        raise ValueError(f"{name}: lidx holds slots in [{lo}, {hi}], outside [0, {U})")
    lidx._slots_checked = mark


def _launch_build(entry: str, F_e: torch.Tensor, lidx: torch.Tensor, B: int, U: int) -> torch.Tensor:
    out = torch.empty((B, U, U), dtype=torch.float32, device=F_e.device)
    stream = torch.cuda.current_stream(F_e.device).cuda_stream
    E, nloc, _ = F_e.shape
    cuda_lib.check(
        getattr(cuda_lib.load(), entry)(
            F_e.data_ptr(), lidx.data_ptr(), out.data_ptr(),
            E, B, lidx.shape[1], nloc, U, stream,
        ),
        entry,
    )
    return out


def macro_build(F_e: torch.Tensor, lidx: torch.Tensor, B: int, U: int) -> torch.Tensor:
    """Block values FtT [B, U, U] from element matrices F_e [E, nloc, nloc]
    and the local slot table lidx [B, c_blk, nloc] (kernel B: persistent
    CTAs, two shared-memory tiles, bulk-copy staging and write-out)."""
    if F_e.device.type == "cpu":
        return macro_build_plain(F_e, lidx, B, U)
    _check_build_args("macro_build", F_e, lidx, B, U)
    smem = cuda_lib.load().ns_macro_build_smem_bytes(lidx.shape[1], F_e.shape[1], U)
    if U % 2 or smem > _MAX_SMEM:
        raise ValueError(
            f"macro_build: U={U} must be even and its {smem} bytes of shared "
            f"memory at most {_MAX_SMEM}"
        )
    out = _launch_build("ns_macro_build_f32", F_e, lidx, B, U)
    launch_counts["macro_build"] += 1
    return out


def macro_build_v1(F_e: torch.Tensor, lidx: torch.Tensor, B: int, U: int) -> torch.Tensor:
    """Kernel B's earlier design (one CTA a block, one tile), on CUDA
    tensors only.  Not on any path: kept to time the designs in turns."""
    _check_build_args("macro_build_v1", F_e, lidx, B, U)
    if U * U * 4 > _MAX_SMEM:
        raise ValueError(f"macro_build_v1: a [{U}, {U}] f32 tile exceeds shared memory")
    return _launch_build("ns_macro_build_v1_f32", F_e, lidx, B, U)


def build_macro_values(mp: MacroPlan, F_e: torch.Tensor) -> torch.Tensor:
    """Per-step block values FtT [B, U, U] ("vu" layout) from F_e."""
    return macro_build(F_e.contiguous(), mp.lidx, mp.B, mp.U)


# ----------------------------------------------------------------------
# Kernel A: block matvec
# ----------------------------------------------------------------------
def macro_matvec_plain(FtT: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel A: y[b, u, c] = sum_v FtT[b, v, u] x_b[b, v, c]."""
    return torch.einsum("bvu,bvc->buc", FtT, x_b)


def macro_matvec(FtT: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
    """Batched block matvec [B, U, U] x [B, U, C] -> [B, U, C] (kernel A)."""
    if FtT.device.type == "cpu":
        return macro_matvec_plain(FtT, x_b)
    if FtT.device.type != "cuda":
        raise ValueError(f"macro_matvec: unsupported device {FtT.device}")
    B, U, U2 = FtT.shape
    if FtT.dtype != torch.float32 or not FtT.is_contiguous() or U2 != U:
        raise ValueError(
            "macro_matvec: FtT must be a contiguous float32 [B, U, U] tensor, "
            f"got {FtT.dtype} {tuple(FtT.shape)}"
        )
    lib = cuda_lib.load()
    C = x_b.shape[-1] if x_b.dim() == 3 else -1
    if (
        x_b.dtype != torch.float32 or not x_b.is_contiguous()
        or x_b.device != FtT.device or tuple(x_b.shape[:2]) != (B, U)
        or not 1 <= C <= lib.ns_macro_max_channels()
    ):
        raise ValueError(
            "macro_matvec: x_b must be a contiguous float32 [B, U, C] tensor "
            f"on FtT's device with 1 <= C <= {lib.ns_macro_max_channels()}, "
            f"got {x_b.dtype} {tuple(x_b.shape)}"
        )
    y = torch.empty((B, U, C), dtype=torch.float32, device=FtT.device)
    stream = torch.cuda.current_stream(FtT.device).cuda_stream
    cuda_lib.check(
        lib.ns_macro_matvec_f32(
            FtT.data_ptr(), x_b.data_ptr(), y.data_ptr(), B, U, C, stream
        ),
        "macro_matvec",
    )
    launch_counts["macro_matvec"] += 1
    return y


# ----------------------------------------------------------------------
# Slot views and applies
# ----------------------------------------------------------------------
def slot_gather(mp: MacroPlan, x: torch.Tensor) -> torch.Tensor:
    """[n, C] -> [B, U, C] block-slot view (pad slots read zero)."""
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    return xp[mp.uidx]


def slot_expand_elem(mp: MacroPlan, x_b: torch.Tensor) -> torch.Tensor:
    """[B, U, C] slot view -> [E, nloc, C] element view: a plain gather
    (each cell node reads its own block slot), equal to u[cells_u]."""
    return x_b.reshape(mp.B * mp.U, x_b.shape[-1])[mp.elem_slot]


def node_reduce(mp: MacroPlan, y_b: torch.Tensor) -> torch.Tensor:
    """[B, U, C] slot contributions -> [n, C]."""
    return apply_segment_plan(mp.plan, y_b.reshape(mp.B * mp.U, y_b.shape[-1]))


def apply_macro(mp: MacroPlan, FtT: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = F u via the block values: [n, C] -> [n, C]."""
    return node_reduce(mp, macro_matvec(FtT, slot_gather(mp, u)))


def apply_rhs_and_r0_macro(
    mp: MacroPlan, MtT: torch.Tensor, FtT: torch.Tensor, hist: torch.Tensor,
    u0: torch.Tensor, x_b: torch.Tensor | None = None,
):
    """(M hist, F u0) from one slot gather and one node reduce: the mass
    blocks MtT act on the hist channels, FtT on the u0 channels (two
    kernel-A launches).  `x_b` is a pre-gathered [B, U, >= 2d] slot view
    of [hist | u0 | ...]."""
    d = hist.shape[1]
    if x_b is None:
        x_b = slot_gather(mp, torch.cat([hist, u0], dim=1))
    y_b = torch.cat(
        [
            macro_matvec(MtT, x_b[..., :d].contiguous()),
            macro_matvec(FtT, x_b[..., d:2 * d].contiguous()),
        ],
        dim=-1,
    )
    y = node_reduce(mp, y_b)
    return y[:, :d], y[:, d:]


def build_macro_mass(mp: MacroPlan, MHAT: torch.Tensor, detJ: torch.Tensor) -> torch.Tensor:
    """Setup-time macro form of the velocity mass M (values "vu")."""
    return build_macro_values(mp, MHAT[None] * detJ[:, None, None])
