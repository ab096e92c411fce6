"""Sparse approximate inverse (SPAI) of the Schur block, for the block
preconditioners' s_solver "spai" / "spai_cg".

The counterpart of the reference's `ops/spai.py build_spai_values`: the
row-wise Frobenius-norm least squares M = argmin ||M S~ - I||_F on S~'s own
pattern, computed once at set-up on the host (numpy, float64) from the
convection-free diag(F) = diag(M)/dt + nu diag(A), and laid out in the
flat slot order of the per-step S~ (`ops/schur_ell.py`), so that one
`schur_ell_matvec` applies it.
"""

from __future__ import annotations

import numpy as np


def build_spai_values(op, host: dict, nu: float, dt: float) -> np.ndarray:
    """SPAI values on S~'s pattern, flat slot layout.  `host` is the host
    dict of `build_operator` (the ELL rows of D and the slot layout)."""
    import scipy.sparse as sp

    n_p = host["n_rows"]
    mask_u = op.dirichlet_mask.cpu().numpy()
    dF0 = op.diagM.cpu().double().numpy() / dt + nu * op.diagA.cpu().double().numpy()
    inv = np.where(mask_u, 0.0, 1.0 / dF0)

    # S~ = D diag(inv) D^T from the host ELL rows of D.
    D_cols = np.asarray(host["D_cols"])  # [n_p, Wd]
    D_vals = np.asarray(host["D_vals"], dtype=np.float64)  # [n_p, Wd, dim]
    n_u = inv.shape[0]
    dim = D_vals.shape[2]
    rows = np.repeat(np.arange(n_p), D_cols.shape[1] * dim)
    cols = (
        np.repeat(D_cols, dim, axis=1) * dim
        + np.tile(np.arange(dim), (n_p, D_cols.shape[1]))
    ).reshape(-1)
    Dsp = sp.csr_matrix((D_vals.reshape(-1), (rows, cols)), shape=(n_p, n_u * dim))
    W = sp.diags(np.repeat(inv, dim))
    S = (Dsp @ W @ Dsp.T).tocsr()
    S.eliminate_zeros()

    # Row-wise Frobenius SPAI on S's own pattern: for row i solve
    # min || S[:, J]^T m - e_i || over J = pattern(i) (S symmetric).
    indptr, indices = S.indptr, S.indices
    m_rows, m_cols, m_vals = [], [], []
    for i in range(n_p):
        J = indices[indptr[i]:indptr[i + 1]]
        sub = S[J]  # rows J
        I = np.unique(sub.indices)
        A = sub[:, I].toarray().T  # [|I|, |J|] = S[I, J]
        e = (I == i).astype(np.float64)
        m, *_ = np.linalg.lstsq(A, e, rcond=None)
        m_rows.append(np.full(len(J), i))
        m_cols.append(J)
        m_vals.append(m)
    m_rows = np.concatenate(m_rows)
    m_cols = np.concatenate(m_cols)
    m_vals = np.concatenate(m_vals)

    # Pack into the flat slot layout by (row, col) key lookup.
    srow, scol, smask = host["srow"], host["scol"], host["smask"]
    mkeys = m_rows.astype(np.int64) * n_p + m_cols
    order = np.argsort(mkeys, kind="stable")
    mkeys_s, mvals_s = mkeys[order], m_vals[order]
    skeys = srow.astype(np.int64) * n_p + scol
    pos = np.minimum(np.searchsorted(mkeys_s, skeys), len(mkeys_s) - 1)
    hit = (mkeys_s[pos] == skeys) & smask
    out = np.zeros(len(skeys))
    out[hit] = mvals_s[pos[hit]]
    return out
