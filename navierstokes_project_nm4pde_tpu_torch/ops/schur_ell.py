"""The Schur operator S~ = D diag(inv) D^T in ELL form: host tables, the
per-step device assembly, and the SpMV.

The counterpart of the reference's `ops/schur_ell.py`:

  * `build_schur_frozen` (host): pattern and float64 values of the frozen
    S1 = D diag(M)^-1 D^T by one scipy SpGEMM per velocity component;
  * `build_schur_ell` (host): the pattern of every (i, j) pressure pair
    that shares a velocity node, and the upper-triangle pair-product table
    S~[i, j] = sum_k D[i, k] . D[j, k] inv[k] that the per-step assembly
    reduces;
  * `SchurELL` on the device: `assemble_schur_values` (one gather of inv,
    one product, one segmented sum by slot, the mirror of the lower
    triangle), `schur_ell_matvec`, `schur_ell_diag`, and the low-precision
    pair `masked_bf16_vals` / `schur_ell_matvec_bf16`.

Both host functions lay the values out in the reference's flat slot order (rows
grouped into two valence buckets split at 32 entries, each bucket a padded
[rows, W] block, columns sorted within a row), so values, `srow`/`scol`/
`smask` and `diag_slot` agree with it slot for slot.  The SpMV is a gather
plus a row sum over each bucket's padded block.  The pair table is built
from a boolean SpGEMM (the pattern) and one sorted-key lookup (each
product's slot), not by the reference's `np.unique` over every pair.
The assembly and the SpMV run inside spans (`utils/profiling.py`:
`schur.ell_assemble`, `schur.ell_matvec`) that record their sizes while a
profiler runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.ops.scatter import build_segment_plan
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class SchurELL:
    """Device structure of S~ for the SpMV and, with its assembly tables,
    the per-step value assembly."""

    cols: tuple  # per bucket: [rows_b, W_b] int64 column ids (pad: own row)
    mask: tuple  # per bucket: [rows_b, W_b] 1.0 where a real entry exists
    row_unperm: torch.Tensor  # [n_p] bucket order -> natural row order
    slot_base: tuple  # first flat slot of each bucket
    # Assembly tables (None for the frozen S1, assembled once on the host):
    # the upper-triangle products sorted by their slot, the velocity node of
    # each, the products per slot, and the mirror of the lower triangle.
    prod_vals: torch.Tensor | None = None  # [T]
    prod_k: torch.Tensor | None = None  # [T] int64
    slot_lengths: torch.Tensor | None = None  # [n_slots] int64
    mirror: torch.Tensor | None = None  # [n_slots] int64
    diag_slot: torch.Tensor | None = None  # [n_p] int64


def _bucket_layout(counts: np.ndarray):
    """The reference's valence-bucketed slot layout of rows with `counts`
    entries: (widths, cls, row_order, unperm, base, n_slots)."""
    n_p = counts.shape[0]
    thresholds = (32,)
    kmax = int(counts.max()) if n_p else 1
    widths = [t for t in thresholds if t < kmax] + [max(kmax, 1)]
    cls = np.searchsorted(np.asarray(widths), counts)
    row_order = np.argsort(cls, kind="stable")  # rows grouped by class
    unperm = np.empty(n_p, dtype=np.int64)
    unperm[row_order] = np.arange(n_p)
    Wb = np.asarray(widths)[cls]
    base_grouped = np.concatenate([[0], np.cumsum(Wb[row_order])[:-1]])
    base = np.empty(n_p, dtype=np.int64)
    base[row_order] = base_grouped
    return widths, cls, row_order, unperm, base, int(Wb.sum())


def _layout_csr(indptr: np.ndarray, indices: np.ndarray, n_p: int) -> dict:
    """The bucketed layout of a row-sorted CSR pattern: per-bucket column
    and mask tables, the flat slot of every CSR entry, and the host slot
    tables (srow, scol, smask) of the reference's host dict."""
    counts = np.diff(indptr)
    widths, cls, row_order, unperm, base, n_slots = _bucket_layout(counts)
    nnz = int(indptr[-1])
    erow = np.repeat(np.arange(n_p, dtype=np.int64), counts)
    slot_in_row = np.arange(nnz, dtype=np.int64) - indptr[:-1][erow]
    flat_slot = base[erow] + slot_in_row
    cols_t, mask_t, slot_base = [], [], []
    off = 0
    for bnum, W in enumerate(widths):
        rows_b = row_order[cls[row_order] == bnum]
        cb = np.tile(rows_b[:, None], (1, W))  # pad: own row id
        mb = np.zeros((len(rows_b), W), dtype=bool)
        sel = cls[erow] == bnum
        pos_in_bucket = (base[erow[sel]] - off) // W
        cb[pos_in_bucket, slot_in_row[sel]] = indices[sel]
        mb[pos_in_bucket, slot_in_row[sel]] = True
        cols_t.append(cb)
        mask_t.append(mb)
        slot_base.append(off)
        off += len(rows_b) * W
    srow = np.concatenate([
        np.repeat(row_order[cls[row_order] == bnum], W) for bnum, W in enumerate(widths)
    ])
    return dict(
        erow=erow, flat_slot=flat_slot, n_slots=n_slots, n_rows=n_p,
        cols_t=cols_t, mask_t=mask_t, slot_base=tuple(slot_base), unperm=unperm,
        srow=srow, scol=np.concatenate([c.reshape(-1) for c in cols_t]),
        smask=np.concatenate([m.reshape(-1) for m in mask_t]),
    )


def _diag_slot(lay: dict, indices: np.ndarray) -> np.ndarray:
    erow, n_p = lay["erow"], lay["n_rows"]
    is_diag = indices == erow
    if not np.array_equal(np.bincount(erow[is_diag], minlength=n_p), np.ones(n_p, np.int64)):
        raise ValueError("every S row needs exactly one diagonal slot")
    diag_slot = np.zeros(n_p, dtype=np.int64)
    diag_slot[erow[is_diag]] = lay["flat_slot"][is_diag]
    return diag_slot


def _host_dict(lay: dict, **extra) -> dict:
    keep = ("n_slots", "n_rows", "srow", "scol", "smask", "cols_t", "mask_t", "slot_base", "unperm")
    return dict({k: lay[k] for k in keep}, **extra)


def build_schur_frozen(
    D_cols: np.ndarray, D_vals: np.ndarray, inv_dF: np.ndarray, n_unodes: int
) -> dict:
    """Pattern and values of S1 = D diag(inv_dF) D^T.

    Returns the host dict {vals1, diag_slot, n_slots, n_rows, srow, scol,
    smask} plus the bucket tables `schur_from_host` reads.  scipy prunes
    numerically-zero entries (pairs sharing only Dirichlet-masked velocity
    nodes); missing diagonals are re-injected so every row keeps a
    diagonal slot for the Jacobi diagonal."""
    import scipy.sparse as sp

    n_p, Wd, dim = D_vals.shape
    real = np.abs(D_vals).sum(axis=2) > 0
    ridx, widx = np.nonzero(real)
    kcol = D_cols[ridx, widx]

    S = None
    for d in range(dim):
        Dd = sp.csr_matrix(
            (D_vals[ridx, widx, d], (ridx, kcol)), shape=(n_p, n_unodes)
        )
        Ds = Dd.copy()
        Ds.data = Ds.data * inv_dF[Ds.indices]
        Sd = Ds @ Dd.T
        S = Sd if S is None else S + Sd
    S = S.tocoo()
    has_diag = np.zeros(n_p, dtype=bool)
    has_diag[S.row[S.row == S.col]] = True
    missing = np.nonzero(~has_diag)[0]
    if len(missing):
        S = sp.csr_matrix(
            (
                np.concatenate([S.data, np.zeros(len(missing))]),
                (
                    np.concatenate([S.row, missing]),
                    np.concatenate([S.col, missing]),
                ),
            ),
            shape=(n_p, n_p),
        )
    else:
        S = S.tocsr()
    S.sum_duplicates()
    S.sort_indices()
    lay = _layout_csr(S.indptr, S.indices.astype(np.int64), n_p)
    vals1 = np.zeros(lay["n_slots"])
    vals1[lay["flat_slot"]] = S.data
    return _host_dict(lay, vals1=vals1, diag_slot=_diag_slot(lay, S.indices))


def build_schur_ell(D_cols: np.ndarray, D_vals: np.ndarray) -> dict:
    """The per-step assembly's host tables: the pattern of every pressure
    pair (i, j) sharing a velocity node k where both D rows are nonzero (the
    reference's pattern, numerically zero entries included), and the
    upper-triangle products D[i, k] . D[j, k] with their node k and slot.

    Returns the host dict {prod_val, prod_k, prod_slot, mirror, diag_slot,
    n_slots, n_rows, srow, scol, smask} plus the bucket tables."""
    import scipy.sparse as sp

    n_p, Wd, dim = D_vals.shape
    real = np.abs(D_vals).sum(axis=2) > 0
    ridx, widx = np.nonzero(real)
    kcol = D_cols[ridx, widx]
    n_u = int(kcol.max()) + 1 if kcol.size else 1
    Db = sp.csr_matrix((np.ones(ridx.shape[0]), (ridx, kcol)), shape=(n_p, n_u))
    P = (Db @ Db.T).tocsr()  # positive counts: no entry cancels
    P.sort_indices()
    indices = P.indices.astype(np.int64)
    lay = _layout_csr(P.indptr, indices, n_p)
    flat_slot = lay["flat_slot"]
    keys = lay["erow"] * np.int64(n_p) + indices  # ascending (row-sorted CSR)

    # For each velocity node k, the pressure rows touching it, ascending.
    order = np.argsort(kcol, kind="stable")
    kcol_s, ridx_s, vals_s = kcol[order], ridx[order], D_vals[ridx[order], widx[order]]
    uniq_k, k_start, k_counts = np.unique(kcol_s, return_index=True, return_counts=True)
    # Upper pairs a <= b within each node's run, grouped by run length.
    pi, pj, pk = [], [], []
    for c in np.unique(k_counts):
        runs = np.nonzero(k_counts == c)[0]
        a, b = np.triu_indices(int(c))
        start = k_start[runs][:, None]
        pi.append((start + a[None, :]).reshape(-1))
        pj.append((start + b[None, :]).reshape(-1))
        pk.append(np.repeat(uniq_k[runs], a.shape[0]))
    gi, gj, prod_k = np.concatenate(pi), np.concatenate(pj), np.concatenate(pk)
    prod_val = np.einsum("pd,pd->p", vals_s[gi], vals_s[gj])
    prod_slot = flat_slot[np.searchsorted(keys, ridx_s[gi] * np.int64(n_p) + ridx_s[gj])]

    mirror = np.arange(lay["n_slots"], dtype=np.int64)
    lower = lay["erow"] > indices
    tpos = np.searchsorted(keys, indices[lower] * np.int64(n_p) + lay["erow"][lower])
    mirror[flat_slot[lower]] = flat_slot[tpos]
    return _host_dict(
        lay, prod_val=prod_val, prod_k=prod_k, prod_slot=prod_slot, mirror=mirror,
        diag_slot=_diag_slot(lay, indices),
    )


def schur_from_host(host: dict, dtype, device, assembly: bool = False) -> SchurELL:
    """The device SchurELL of a host dict (with `assembly`, the per-step
    assembly tables of `build_schur_ell` too)."""
    idx = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)  # noqa: E731
    asm = {}
    if assembly:
        # products sorted by slot (stable): the segmented sum is a gather-free
        # reduction over contiguous runs
        plan = build_segment_plan(host["prod_slot"], host["n_slots"], device="cpu")
        perm = plan.perm.numpy()
        asm = dict(
            prod_vals=torch.as_tensor(host["prod_val"][perm], dtype=dtype, device=device),
            prod_k=idx(host["prod_k"][perm]),
            slot_lengths=plan.lengths.to(device),
            mirror=idx(host["mirror"]),
            diag_slot=idx(host["diag_slot"]),
        )
    return SchurELL(
        cols=tuple(idx(c) for c in host["cols_t"]),
        mask=tuple(torch.as_tensor(m, dtype=dtype, device=device) for m in host["mask_t"]),
        row_unperm=idx(host["unperm"]),
        slot_base=host["slot_base"],
        **asm,
    )


def assemble_schur_values(s: SchurELL, inv_dF: torch.Tensor) -> torch.Tensor:
    """Per-step flat values [n_slots] (or [n_slots, B] for one weight
    column a member, inv_dF [n_u, B]): the upper-triangle products weighted
    by inv_dF[k], summed per slot, then the lower triangle mirrored."""
    with span("schur.ell_assemble", n_prod=s.prod_vals.shape[0], n_slots=s.mirror.shape[0],
              cols=inv_dF.numel() // inv_dF.shape[0]):
        prod = s.prod_vals if inv_dF.dim() == 1 else s.prod_vals[:, None]
        w = prod * inv_dF.index_select(0, s.prod_k)
        vals = torch.segment_reduce(w, "sum", lengths=s.slot_lengths, axis=0, unsafe=True)
        return vals.index_select(0, s.mirror)


def _bucket_views(s: SchurELL, vals: torch.Tensor):
    """Per bucket: (cols, masked values [rows_b, W, *members])."""
    for b, cols in enumerate(s.cols):
        rows_b, W = cols.shape
        off = s.slot_base[b]
        vb = vals[off:off + rows_b * W].view(rows_b, W, *vals.shape[1:])
        yield cols, vb * s.mask[b].view(rows_b, W, *(1,) * (vals.dim() - 1))


def _spread(vb: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Shared values [rows, W] against members p [n_p, B]: [rows, W, 1]."""
    return vb.view(*vb.shape, *(1,) * (p.dim() - 1)) if vb.dim() == 2 else vb


def schur_ell_matvec(s: SchurELL, vals: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """S~ p for p [n_p] or [n_p, B], with values [n_slots] shared by the
    columns or [n_slots, B] one set a column: a gather of p and a row sum
    over each bucket's padded block.  Its span is no cut of a captured
    graph: the frozen ELL fallback's pressure CG keeps its graphs whole."""
    with span("schur.ell_matvec", cut=False, rows=tuple(c.shape[0] for c in s.cols),
              width=tuple(c.shape[1] for c in s.cols), n_p=p.shape[0], cols=p.numel() // p.shape[0],
              vcols=vals.numel() // vals.shape[0], itemsize=vals.element_size(),
              index_itemsize=s.cols[0].element_size()):
        outs = [(_spread(vb, p) * p[cb]).sum(1) for cb, vb in _bucket_views(s, vals)]
        return torch.cat(outs).index_select(0, s.row_unperm)


def masked_bf16_vals(s: SchurELL, vals: torch.Tensor) -> tuple:
    """Per-bucket masked values in bfloat16 (the low-precision SpMV's)."""
    return tuple(vb.to(torch.bfloat16) for _, vb in _bucket_views(s, vals))


def schur_ell_matvec_bf16(s: SchurELL, vals16: tuple, p: torch.Tensor, out_dtype) -> torch.Tensor:
    """bfloat16-payload SpMV: bfloat16 products, summed in `out_dtype`."""
    p16 = p.to(torch.bfloat16)
    outs = [(_spread(vals16[b], p) * p16[cols]).to(out_dtype).sum(1) for b, cols in enumerate(s.cols)]
    return torch.cat(outs).index_select(0, s.row_unperm)


def schur_ell_diag(s: SchurELL, vals: torch.Tensor) -> torch.Tensor:
    return vals.index_select(0, s.diag_slot)
