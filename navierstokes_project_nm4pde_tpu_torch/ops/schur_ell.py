"""Host-side frozen Schur operator S1 = D diag(inv) D^T (numpy/scipy).

The counterpart of the reference's `ops/schur_ell.py` `build_schur_frozen`:
one scipy SpGEMM per velocity component gives the pattern and float64
values, laid out in the reference's valence-bucketed ELL slot order so
`vals1`, `srow`/`scol`/`smask` and `diag_slot` match it slot for slot (the
coarse and banded builders read them).  The device-side ELL SpMV is not
ported: the projection stepper applies S1 through the banded form
(`ops/banded.py`).
"""

from __future__ import annotations

import numpy as np


def build_schur_frozen(
    D_cols: np.ndarray, D_vals: np.ndarray, inv_dF: np.ndarray, n_unodes: int
) -> dict:
    """Pattern and values of S1 = D diag(inv_dF) D^T.

    Returns the host dict {vals1, diag_slot, n_slots, srow, scol, smask,
    n_rows}.  scipy prunes numerically-zero entries (pairs sharing only
    Dirichlet-masked velocity nodes); missing diagonals are re-injected so
    every row keeps a diagonal slot for the Jacobi diagonal."""
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
    counts = np.diff(S.indptr)

    # Valence-bucketed slot layout (two buckets split at 32 entries), the
    # reference's, so the host tables agree with it slot for slot.
    thresholds = (32,)
    kmax = int(counts.max()) if n_p else 1
    widths = [t for t in thresholds if t < kmax] + [max(kmax, 1)]
    cls = np.searchsorted(np.asarray(widths), counts)
    row_order = np.argsort(cls, kind="stable")
    Wb = np.asarray(widths)[cls]
    base_grouped = np.concatenate([[0], np.cumsum(Wb[row_order])[:-1]])
    base = np.empty(n_p, dtype=np.int64)
    base[row_order] = base_grouped
    n_slots = int(Wb.sum())

    nnz = int(S.indptr[-1])
    erow = np.repeat(np.arange(n_p, dtype=np.int64), counts)
    slot_in_row = np.arange(nnz, dtype=np.int64) - S.indptr[:-1][erow]
    flat_slot = base[erow] + slot_in_row

    vals1 = np.zeros(n_slots)
    vals1[flat_slot] = S.data

    cols_t, mask_t = [], []
    off = 0
    for bnum, W in enumerate(widths):
        rows_b = row_order[cls[row_order] == bnum]
        cb = np.tile(rows_b[:, None], (1, W))  # pad: own row id
        mb = np.zeros((len(rows_b), W), dtype=bool)
        sel = cls[erow] == bnum
        pos_in_bucket = (base[erow[sel]] - off) // W
        cb[pos_in_bucket, slot_in_row[sel]] = S.indices[sel]
        mb[pos_in_bucket, slot_in_row[sel]] = True
        cols_t.append(cb)
        mask_t.append(mb)
        off += len(rows_b) * W

    is_diag = S.indices == erow
    if not np.array_equal(
        np.bincount(erow[is_diag], minlength=n_p), np.ones(n_p, np.int64)
    ):
        raise ValueError("every S1 row needs exactly one diagonal slot")
    diag_slot = np.zeros(n_p, dtype=np.int64)
    diag_slot[erow[is_diag]] = flat_slot[is_diag]

    srow = np.concatenate([
        np.repeat(row_order[cls[row_order] == bnum], W)
        for bnum, W in enumerate(widths)
    ])
    return dict(
        vals1=vals1,
        diag_slot=diag_slot,
        n_slots=n_slots,
        n_rows=n_p,
        srow=srow,
        scol=np.concatenate([c.reshape(-1) for c in cols_t]),
        smask=np.concatenate([m.reshape(-1) for m in mask_t]),
    )
