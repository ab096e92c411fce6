"""ctypes bindings for the native meshkit library (with numpy fallback).

The port's copy of the JAX package's `mesh/native.py`.  The combinatorial
mesh setup (edge extraction, facet matching, index-map inversion) runs on
the host; the kernels in `native/meshkit.cpp` replace numpy's sort/unique
pipeline with O(N) hash/counting passes.  The library is built lazily
(`make -C native`); every entry point has a pure numpy fallback, so the
port works without a host compiler.  This module sits at the same depth
as the JAX package's, so `_repo_root()` finds the same `native/`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _repo_root():
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def load_meshkit():
    """Load (building if necessary) libmeshkit.so; returns None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_repo_root(), "native", "libmeshkit.so")
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(so)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.meshkit_build_edges.restype = ctypes.c_int64
    lib.meshkit_build_edges.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int32,
        ctypes.c_int64, i32p, i32p,
    ]
    lib.meshkit_invert_map.restype = ctypes.c_int64
    lib.meshkit_invert_map.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.meshkit_fill_slots.restype = None
    lib.meshkit_fill_slots.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i64p, i32p,
    ]
    lib.meshkit_match_facets.restype = ctypes.c_int64
    lib.meshkit_match_facets.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int64,
        ctypes.c_int32, i32p, i32p,
    ]
    _LIB = lib
    return _LIB


# ----------------------------------------------------------------------
def build_edges(cells: np.ndarray, loc_edges, n_vertices: int):
    """Unique sorted edges + per-cell edge ids.  Native or numpy."""
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    le = np.ascontiguousarray(np.asarray(loc_edges, dtype=np.int32))
    lib = load_meshkit()
    if lib is not None:
        n_c, nv = cells.shape
        n_le = le.shape[0]
        cap = n_c * n_le
        edge_ids = np.empty((n_c, n_le), dtype=np.int32)
        edges = np.empty((cap, 2), dtype=np.int32)
        n_e = lib.meshkit_build_edges(
            cells, n_c, nv, le.reshape(-1), n_le, cap, edge_ids.reshape(-1),
            edges.reshape(-1),
        )
        if n_e >= 0:
            # Native returns first-seen order; renumber to sorted-key order to
            # match the numpy path bit-for-bit.
            keys = edges[:n_e, 0].astype(np.int64) * np.int64(n_vertices) + edges[:n_e, 1]
            order = np.argsort(keys, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(n_e)
            return edges[:n_e][order], rank[edge_ids]
    # numpy fallback
    pairs = cells[:, le]  # [n_c, n_le, 2]
    flat = np.sort(pairs.reshape(-1, 2), axis=1)
    keys = flat[:, 0].astype(np.int64) * np.int64(n_vertices) + flat[:, 1]
    uniq, inv = np.unique(keys, return_inverse=True)
    edges = np.stack([uniq // n_vertices, uniq % n_vertices], axis=1).astype(np.int32)
    return edges, inv.reshape(cells.shape[0], le.shape[0]).astype(np.int32)


def invert_map(flat: np.ndarray, n_rows: int, pad_value: int):
    """[N] row indices -> (slots [n_rows, K] padded, counts [n_rows])."""
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    lib = load_meshkit()
    if lib is not None:
        counts = np.zeros(n_rows, dtype=np.int64)
        K = lib.meshkit_invert_map(flat, flat.shape[0], n_rows, counts)
        K = max(int(K), 1)
        slots = np.full((n_rows, K), pad_value, dtype=np.int32)
        cursor = np.zeros(n_rows, dtype=np.int64)
        lib.meshkit_fill_slots(
            flat, flat.shape[0], n_rows, K, pad_value, cursor, slots.reshape(-1)
        )
        return slots, counts
    order = np.argsort(flat, kind="stable")
    srt = flat[order]
    counts = np.bincount(srt, minlength=n_rows).astype(np.int64)
    K = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slots = np.full((n_rows, K), pad_value, dtype=np.int32)
    pos = np.arange(len(srt)) - starts[srt]
    slots[srt, pos] = order
    return slots, counts


def match_facets(cells: np.ndarray, bfaces: np.ndarray):
    """Parent (cell, local facet) of each boundary facet.  Native-only helper;
    returns None to signal fallback."""
    lib = load_meshkit()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    bfaces = np.ascontiguousarray(bfaces, dtype=np.int32)
    n_c, nv = cells.shape
    n_bf, fv = bfaces.shape
    bcell = np.empty(n_bf, dtype=np.int32)
    blocal = np.empty(n_bf, dtype=np.int32)
    rc = lib.meshkit_match_facets(
        cells.reshape(-1), n_c, nv, bfaces.reshape(-1), n_bf, fv,
        bcell, blocal,
    )
    if rc != 0:
        return None
    return bcell, blocal
