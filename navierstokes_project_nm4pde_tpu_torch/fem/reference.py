"""Reference simplex elements: P1 and P2 Lagrange shape functions.

The port's copy of the JAX package's `fem/reference.py` (numpy only).

The reference imports these from deal.II (`FE_SimplexP(1)`, `FE_SimplexP(2)`;
ref: src/NavierStokes2D.cpp:31-36).  Here they are closed-form numpy tables:
everything downstream consumes shape values / gradients tabulated at
quadrature points, so the basis only ever exists as small constant ndarrays
that live in VMEM during kernels.

Conventions
-----------
Reference triangle: vertices (0,0), (1,0), (0,1);   barycentric
``lam = (1-x-y, x, y)``.
Reference tetrahedron: vertices (0,0,0),(1,0,0),(0,1,0),(0,0,1);
``lam = (1-x-y-z, x, y, z)``.

P2 node ordering: the d+1 vertices first, then one node per edge midpoint in
the edge order below.  This ordering is a repo-wide contract shared with the
mesh layer (edge extraction) and the DoF map.
"""

from __future__ import annotations

import numpy as np

# Edge orderings (local vertex index pairs).
TRI_EDGES = ((0, 1), (0, 2), (1, 2))
TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _edges(dim: int):
    return TRI_EDGES if dim == 2 else TET_EDGES


def n_p2_nodes(dim: int) -> int:
    return (dim + 1) + len(_edges(dim))  # 6 (tri) / 10 (tet)


def _barycentric(points: np.ndarray) -> np.ndarray:
    """[n, dim] reference coords -> [n, dim+1] barycentric coords."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    lam0 = 1.0 - points.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, points], axis=1)


def _barycentric_grads(dim: int) -> np.ndarray:
    """d(lam_k)/d(xi_j): [dim+1, dim] constant gradients."""
    g = np.zeros((dim + 1, dim), dtype=np.float64)
    g[0, :] = -1.0
    g[1:, :] = np.eye(dim)
    return g


def p1_shape(points: np.ndarray, dim: int) -> np.ndarray:
    """P1 values: [n_points, dim+1] (the barycentric coordinates)."""
    del dim
    return _barycentric(points)


def p2_shape(points: np.ndarray, dim: int) -> np.ndarray:
    """P2 values: [n_points, n_p2_nodes(dim)].

    Vertex nodes: lam*(2 lam - 1); edge nodes: 4 lam_i lam_j.
    """
    lam = _barycentric(points)
    cols = [lam[:, k] * (2.0 * lam[:, k] - 1.0) for k in range(dim + 1)]
    cols += [4.0 * lam[:, i] * lam[:, j] for (i, j) in _edges(dim)]
    return np.stack(cols, axis=1)


def p2_grad(points: np.ndarray, dim: int) -> np.ndarray:
    """P2 reference gradients: [n_points, n_p2_nodes(dim), dim]."""
    lam = _barycentric(points)
    g = _barycentric_grads(dim)  # [dim+1, dim]
    n = lam.shape[0]
    out = np.zeros((n, n_p2_nodes(dim), dim), dtype=np.float64)
    for k in range(dim + 1):
        out[:, k, :] = (4.0 * lam[:, k:k + 1] - 1.0) * g[k]
    for e, (i, j) in enumerate(_edges(dim)):
        out[:, dim + 1 + e, :] = 4.0 * (
            lam[:, i:i + 1] * g[j] + lam[:, j:j + 1] * g[i]
        )
    return out

