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
its plain PyTorch version for CPU tensors; on the card both kernels take
float32 or float64, each in its own type (`max_channels`: kernel A's
widest payload a launch in each), and any even U: a block whose tiles do
not fit one CTA's shared memory is built in bands of rows (`band_rows`),
and where not even a band of whole rows fits, of columns as well
(`build_band_cols`); past 256 slots kernel A splits a block's columns over
CTAs (`band_cols`), and where the block's whole input panel no longer fits
beside them, stages it in chunks of rows (`panel_rows`); each is still one
launch.  `launch_counts` counts the kernel launches only, by entry point
(float32's under the kernel's name, float64's under the name with
`_f64`), and `matvec_channels` kernel A's launches by channel count.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.device import pick_device
from navierstokes_project_nm4pde_tpu_torch.ops import cuda_lib
from navierstokes_project_nm4pde_tpu_torch.ops.scatter import (
    SegmentPlan,
    apply_segment_plan,
    build_segment_plan,
)

launch_counts = {"macro_build": 0, "macro_matvec": 0, "macro_build_f64": 0, "macro_matvec_f64": 0}
matvec_channels: dict[int, int] = {}  # C -> kernel A launches at C channels


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    matvec_channels.clear()


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
    """Raise ValueError for inputs kernel B does not take."""
    if F_e.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {F_e.device}")
    E, nloc, nloc2 = F_e.shape
    if F_e.dtype not in cuda_lib.SUFFIX or not F_e.is_contiguous() or nloc2 != nloc:
        raise ValueError(
            f"{name}: F_e must be a contiguous float32 or float64 [E, nloc, "
            f"nloc] tensor, got {F_e.dtype} {tuple(F_e.shape)}"
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


def band_rows(dtype: torch.dtype, c_blk: int, nloc: int, U: int) -> int:
    """Kernel B's rows a work item on the card: U where a block's tile(s)
    fit one CTA's shared memory (float32: two [U, U] tiles and the input
    stages, up to U = 162 at c_blk 20; float64: one tile, up to U = 170),
    else the most rows that fit, balanced over the bands."""
    return cuda_lib.load().ns_macro_build_band_rows(c_blk, nloc, U, torch.finfo(dtype).bits // 8)


def build_band_cols(dtype: torch.dtype, c_blk: int, nloc: int, U: int) -> int:
    """Kernel B's columns a work item on the card: U, unless not even one
    band of whole rows of its one-tile design fits (float64 past U =
    29,056, float32 past 58,112; half that where U is not a multiple of
    4), and then column bands of about 16 KB a row."""
    return cuda_lib.load().ns_macro_build_band_cols(c_blk, nloc, U, torch.finfo(dtype).bits // 8)


def macro_build(F_e: torch.Tensor, lidx: torch.Tensor, B: int, U: int) -> torch.Tensor:
    """Block values FtT [B, U, U] from element matrices F_e [E, nloc, nloc]
    and the local slot table lidx [B, c_blk, nloc] (kernel B: in float32
    persistent CTAs, two shared-memory tiles, bulk-copy staging and
    write-out; in float64, and in float32 past two tiles of one row, a CTA
    a block and one tile; a wide block's tile in bands of `band_rows` rows
    and `build_band_cols` columns, one launch either way)."""
    if F_e.device.type == "cpu":
        return macro_build_plain(F_e, lidx, B, U)
    _check_build_args("macro_build", F_e, lidx, B, U)
    if U % 2:
        raise ValueError(f"macro_build: U={U} must be even (the tile store moves 16-byte vectors)")
    out = torch.empty((B, U, U), dtype=F_e.dtype, device=F_e.device)
    stream = torch.cuda.current_stream(F_e.device).cuda_stream
    E, nloc, _ = F_e.shape
    entry = f"ns_macro_build_{cuda_lib.SUFFIX[F_e.dtype]}"
    cuda_lib.check(
        getattr(cuda_lib.load(), entry)(
            F_e.data_ptr(), lidx.data_ptr(), out.data_ptr(),
            E, B, lidx.shape[1], nloc, U, stream,
        ),
        entry,
    )
    launch_counts[cuda_lib.count_key("macro_build", F_e.dtype)] += 1
    return out


def build_macro_values(mp: MacroPlan, F_e: torch.Tensor) -> torch.Tensor:
    """Per-step block values FtT [B, U, U] ("vu" layout) from F_e."""
    return macro_build(F_e.contiguous(), mp.lidx, mp.B, mp.U)


# ----------------------------------------------------------------------
# Kernel A: block matvec
# ----------------------------------------------------------------------
def macro_matvec_plain(FtT: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel A: y[b, u, c] = sum_v FtT[b, v, u] x_b[b, v, c]."""
    return torch.einsum("bvu,bvc->buc", FtT, x_b)


def matvec_splits(C: int, max_c: int) -> list:
    """Kernel A's channel slices of a C-channel payload: ceil(C / max_c)
    launches of near-equal width (each reads FtT once)."""
    n = -(-C // max_c)
    edges = [C * k // n for k in range(n + 1)]
    return [(lo, hi) for lo, hi in zip(edges, edges[1:])]


def max_channels(dtype: torch.dtype) -> int:
    """Kernel A's widest payload a launch in `dtype` (24 in float32, 12 in
    float64, whose accumulators take twice the registers)."""
    lib = cuda_lib.load()
    return lib.ns_macro_max_channels_f64() if dtype == torch.float64 else lib.ns_macro_max_channels()


@functools.lru_cache(maxsize=None)
def band_cols(dtype: torch.dtype, C: int, U: int) -> int:
    """Kernel A's output columns a CTA at C channels a launch on the card:
    U up to 256 (a thread a column), else bands of at most 256 (a multiple
    of 32, balanced: 192 at U = 384); up to U = 2,336, narrower where the
    whole input panel then fits beside them."""
    return cuda_lib.load().ns_macro_matvec_band_cols(C, U, torch.finfo(dtype).bits // 8)


def panel_rows(dtype: torch.dtype, C: int, U: int) -> int:
    """Kernel A's input-panel rows a CTA stages at a time at C channels a
    launch: U (the whole [U, C] panel) where it fits beside `band_cols`
    columns (up to U = 2,336 at 24 float32 channels, 2,250 at 12 float64
    ones, 10,432 at 3 float32 ones, 3,168 at 3 float64 ones), else chunks
    of a multiple of 16 rows, the accumulators kept across chunks."""
    return cuda_lib.load().ns_macro_matvec_panel_rows(C, U, torch.finfo(dtype).bits // 8)


def macro_matvec(FtT: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
    """Batched block matvec [B, U, U] x [B, U, C] -> [B, U, C] (kernel A),
    float32 or float64.  Up to `max_channels(dtype)` (24; 12 in float64)
    channels ride one launch and one pass over FtT; a wider payload is
    split into launches of near-equal channel slices (`matvec_splits`),
    each writing its slice of one output and reading FtT once more.  Past
    U = 256 each launch splits a block's columns over CTAs (`band_cols`),
    and stages the input panel in chunks of `panel_rows` rows where it
    does not fit whole."""
    if FtT.device.type == "cpu":
        return macro_matvec_plain(FtT, x_b)
    if FtT.device.type != "cuda":
        raise ValueError(f"macro_matvec: unsupported device {FtT.device}")
    B, U, U2 = FtT.shape
    lib = cuda_lib.load()
    if FtT.dtype not in cuda_lib.SUFFIX or not FtT.is_contiguous() or U2 != U:
        raise ValueError(
            "macro_matvec: FtT must be a contiguous float32 or float64 [B, U, U] "
            f"tensor, got {FtT.dtype} {tuple(FtT.shape)}"
        )
    C = x_b.shape[-1] if x_b.dim() == 3 else -1
    if (
        x_b.dtype != FtT.dtype or not x_b.is_contiguous()
        or x_b.device != FtT.device or tuple(x_b.shape[:2]) != (B, U) or C < 1
    ):
        raise ValueError(
            f"macro_matvec: x_b must be a contiguous {FtT.dtype} [B, U, C] tensor "
            f"on FtT's device with C >= 1, got {x_b.dtype} {tuple(x_b.shape)}"
        )
    splits = matvec_splits(C, max_channels(FtT.dtype))
    y = torch.empty((B, U, C), dtype=FtT.dtype, device=FtT.device)
    stream = torch.cuda.current_stream(FtT.device).cuda_stream
    entry = f"ns_macro_matvec_{cuda_lib.SUFFIX[FtT.dtype]}"
    size = FtT.element_size()
    for lo, hi in splits:
        cuda_lib.check(
            getattr(lib, entry)(
                FtT.data_ptr(), x_b.data_ptr() + size * lo, y.data_ptr() + size * lo,
                B, U, hi - lo, C, C, stream,
            ),
            entry,
        )
        launch_counts[cuda_lib.count_key("macro_matvec", FtT.dtype)] += 1
        matvec_channels[hi - lo] = matvec_channels.get(hi - lo, 0) + 1
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
    u0: torch.Tensor, extra: torch.Tensor | None = None,
    x_b: torch.Tensor | None = None,
):
    """(M hist, F u0[, F extra]) from one slot gather and one node reduce:
    the mass blocks MtT act on the hist channels, FtT on [u0 | extra] in
    one kernel-A launch (the warm-start pool's images F D ride the u0
    channels: 3 + 3k of them at f_warmstart = k).  `x_b` is a pre-gathered
    [B, U, C] slot view of [hist | u0 | extra]."""
    d = hist.shape[1]
    if x_b is None:
        xs = [hist, u0] if extra is None else [hist, u0, extra]
        x_b = slot_gather(mp, torch.cat(xs, dim=1))
    y_b = torch.cat(
        [
            macro_matvec(MtT, x_b[..., :d].contiguous()),
            macro_matvec(FtT, x_b[..., d:].contiguous()),
        ],
        dim=-1,
    )
    y = node_reduce(mp, y_b)
    if extra is None:
        return y[:, :d], y[:, d:]
    return y[:, :d], y[:, d:2 * d], y[:, 2 * d:]


def build_macro_mass(mp: MacroPlan, MHAT: torch.Tensor, detJ: torch.Tensor) -> torch.Tensor:
    """Setup-time macro form of the velocity mass M (values "vu")."""
    return build_macro_values(mp, MHAT[None] * detJ[:, None, None])

