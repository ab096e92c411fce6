"""Block-banded dense form of the frozen Schur operator S1.

The counterpart of the reference's `ops/banded.py`.  After the RCM
reorder S1's pattern is banded, so it is stored once as dense blocks of
`R` consecutive rows sharing one tile-aligned column window:

    vals  [n_blk, R, W]   dense banded values
    tiles [n_blk, T]      128-wide tile ids of each block's window (T*128 = W)

and the SpMV is a window gather plus one batched matvec (`torch.bmm`,
full f32: the precision policy in `device.py` keeps TF32 off).  The dense
values are materialised in float32 on the host, as in the reference.
Each matvec runs in span `schur.banded_matvec` (`utils/profiling.py`),
with its sizes: blocks, rows R, width W, n_rows, columns and element size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.utils.profiling import span

TILE = 128


@dataclasses.dataclass
class BandedSchur:
    vals: torch.Tensor  # [n_blk, R, W]
    tiles: torch.Tensor  # [n_blk, T] int64
    n_rows: int
    n_tiles_pad: int


def build_banded_schur(
    rows, cols, vals, n_rows: int, dtype, device, block_rows: int = 128,
    max_bytes: int = 2 << 30,
) -> BandedSchur | None:
    """From COO triplets (host, one-time).  None when the band is too wide
    for the dense values to fit in `max_bytes`."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)

    R = block_rows
    n_blk = -(-n_rows // R)
    blk = rows // R
    bmin = np.full(n_blk, n_rows, np.int64)
    bmax = np.full(n_blk, 0, np.int64)
    np.minimum.at(bmin, blk, cols)
    np.maximum.at(bmax, blk, cols)
    start = (bmin // TILE) * TILE
    width = bmax - start + 1
    T = int(-(-width.max() // TILE)) if n_blk else 1
    W = T * TILE
    if n_blk * R * W * np.dtype(np.float32).itemsize > max_bytes:
        return None

    n_tiles_p = -(-n_rows // TILE)
    n_tiles_pad = max(n_tiles_p, int((start // TILE).max()) + T if n_blk else T)
    dense = np.zeros((n_blk, R, W), np.float32)
    dense[blk, rows % R, cols - start[blk]] = vals
    tiles = (start // TILE)[:, None] + np.arange(T)[None, :]
    return BandedSchur(
        vals=torch.as_tensor(dense, device=device).to(dtype),
        tiles=torch.as_tensor(tiles, device=device),
        n_rows=n_rows,
        n_tiles_pad=int(n_tiles_pad),
    )


def banded_matvec(b: BandedSchur, p: torch.Tensor) -> torch.Tensor:
    """S1 @ p for p [n] or [n, B] (one column per ensemble member: S1 is
    shared, so all columns ride one pass over the band values)."""
    P = p.reshape(p.shape[0], -1)
    nc = P.shape[1]
    n_blk, R, W = b.vals.shape
    with span("schur.banded_matvec", blocks=n_blk, rows=R, width=W, n_rows=b.n_rows, cols=nc,
              itemsize=b.vals.element_size()):
        pad = b.n_tiles_pad * TILE - p.shape[0]
        p3d = torch.nn.functional.pad(P, (0, 0, 0, pad)).reshape(-1, TILE, nc)
        win = p3d[b.tiles].reshape(n_blk, W, nc)
        return torch.bmm(b.vals, win).reshape(-1, nc)[: b.n_rows].reshape(p.shape)
