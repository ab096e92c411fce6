"""Plain P2-P1 (Taylor-Hood) finite elements on tetrahedra, in NumPy and
PyTorch: the benchmark's reference operators.

Written from the textbook definitions, not from the program: the P2 basis
in barycentric coordinates (vertex functions l_i (2 l_i - 1), edge
functions 4 l_i l_j), every reference integral exact by the monomial
formula  int_T^ l^a = prod(a_i!) / (|a| + 3)!  on the unit tetrahedron, and
affine geometry.  It imports nothing of the program and takes nothing the
program made: the mesh arrays are the benchmark's own (`nsbench.meshgen`).

Operators on velocity u [n_u, 3] and pressure p [n_p] (P1 on the vertices):

  M        mass                      int u . v
  K        vector Laplacian          int grad u : grad v
  C(w)     convection + Temam term   int (w . grad u) . v + 1/2 (div w) u . v
  F        M / dt + nu K + C(w)
  D        divergence                (D u)_q = int q div u
  D^T      its transpose (the weak gradient is -D^T)

Every contraction runs through `RefOperator.mm`, which in the "tf32" mode
rounds both operands to TF32's 10-bit mantissa before a float32 product:
that mode is the control of the correctness check (the reference computed
one precision step below the float32 the configuration states).
"""

from __future__ import annotations

import itertools
import math
import warnings

import numpy as np
import torch

LOCAL_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


# ----------------------------------------------------------------------
# Polynomials in the four barycentric coordinates: {exponents: coefficient}
# ----------------------------------------------------------------------
def _mono(i: int, power: int = 1) -> tuple:
    e = [0, 0, 0, 0]
    e[i] = power
    return tuple(e)


def _mul(p: dict, q: dict) -> dict:
    out: dict = {}
    for a, ca in p.items():
        for b, cb in q.items():
            k = tuple(x + y for x, y in zip(a, b))
            out[k] = out.get(k, 0.0) + ca * cb
    return out


def _diff(p: dict, m: int) -> dict:
    out: dict = {}
    for a, c in p.items():
        if a[m]:
            k = list(a)
            k[m] -= 1
            out[tuple(k)] = out.get(tuple(k), 0.0) + c * a[m]
    return out


def _integrate(p: dict) -> float:
    """Exact integral over the unit reference tetrahedron (volume 1/6)."""
    return sum(
        c * math.prod(math.factorial(x) for x in a) / math.factorial(sum(a) + 3)
        for a, c in p.items()
    )


def _evaluate(p: dict, lam) -> float:
    return sum(c * math.prod(l**x for l, x in zip(lam, a)) for a, c in p.items())


def p2_basis() -> list:
    """The ten P2 shape functions: vertices 0-3, then LOCAL_EDGES."""
    basis = [{_mono(i, 2): 2.0, _mono(i): -1.0} for i in range(4)]
    basis += [{tuple(int(k in e) for k in range(4)): 4.0} for e in LOCAL_EDGES]
    return basis


def p1_basis() -> list:
    return [{_mono(i): 1.0} for i in range(4)]


def reference_tables() -> dict:
    """Exact reference-element tables (float64 numpy):
    MHAT [i, j] = int phi_i phi_j;
    AH [m, n, i, j] = int d_m phi_i d_n phi_j   (d_m = d / d lambda_m);
    CT [k, m, i, j] = int phi_i phi_k d_m phi_j + 1/2 phi_i phi_j d_m phi_k;
    BH [q, m, j] = int psi_q d_m phi_j           (psi: P1).
    On a cell, grad phi = sum_m d_m phi grad(lambda_m), and an integral is
    |det J| times the reference one."""
    phi, psi = p2_basis(), p1_basis()
    dphi = [[_diff(f, m) for m in range(4)] for f in phi]
    n = len(phi)
    mhat = np.array([[_integrate(_mul(phi[i], phi[j])) for j in range(n)] for i in range(n)])
    ah = np.zeros((4, 4, n, n))
    for m, k, i, j in itertools.product(range(4), range(4), range(n), range(n)):
        ah[m, k, i, j] = _integrate(_mul(dphi[i][m], dphi[j][k]))
    ct = np.zeros((n, 4, n, n))
    for k, m, i, j in itertools.product(range(n), range(4), range(n), range(n)):
        ct[k, m, i, j] = _integrate(_mul(_mul(phi[i], phi[k]), dphi[j][m])) + 0.5 * _integrate(
            _mul(_mul(phi[i], phi[j]), dphi[k][m])
        )
    bh = np.zeros((4, 4, n))
    for q, m, j in itertools.product(range(4), range(4), range(n)):
        bh[q, m, j] = _integrate(_mul(psi[q], dphi[j][m]))
    return dict(MHAT=mhat, AH=ah, CT=ct, BH=bh)


def face_centroid_derivatives() -> np.ndarray:
    """[o, m, j]: d_m phi_j at the centroid of the face opposite local
    vertex o (lambda = 1/3 on the face's vertices, 0 at o)."""
    phi = p2_basis()
    out = np.zeros((4, 4, len(phi)))
    for o in range(4):
        lam = [0.0 if i == o else 1.0 / 3.0 for i in range(4)]
        for m in range(4):
            for j, f in enumerate(phi):
                out[o, m, j] = _evaluate(_diff(f, m), lam)
    return out


# ----------------------------------------------------------------------
# The mesh's P2 space
# ----------------------------------------------------------------------
def _void_keys(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).reshape(-1)


class P2Space:
    """The P2 velocity nodes (the vertices, then one node an edge at its
    midpoint) and P1 pressure nodes (the vertices) of a tetrahedral mesh
    given as arrays, with affine geometry and boundary nodes by tag."""

    def __init__(self, coords, cells, bface_verts, bface_tag):
        self.coords = np.asarray(coords, dtype=np.float64)
        self.cells = np.asarray(cells, dtype=np.int64)
        self.bface_verts = np.asarray(bface_verts, dtype=np.int64)
        self.bface_tag = np.asarray(bface_tag)
        n_v = self.coords.shape[0]
        pairs = np.sort(self.cells[:, np.array(LOCAL_EDGES)], axis=2).reshape(-1, 2)
        edges, inv = np.unique(pairs, axis=0, return_inverse=True)
        self.edges = edges
        self.cells_u = np.concatenate([self.cells, n_v + inv.reshape(-1, 6)], axis=1)
        self.n_p = n_v
        self.n_u = n_v + edges.shape[0]
        self.node_coords = np.concatenate(
            [self.coords, 0.5 * (self.coords[edges[:, 0]] + self.coords[edges[:, 1]])]
        )
        v = self.coords[self.cells]  # [E, 4, 3]
        J = np.transpose(v[:, 1:] - v[:, :1], (0, 2, 1))  # columns x_i - x_0
        self.detJ = np.abs(np.linalg.det(J))
        jinv = np.linalg.inv(J)  # rows: grad lambda_1..3
        self.gradlam = np.concatenate([-jinv.sum(axis=1, keepdims=True), jinv], axis=1)  # [E, 4, 3]
        self._edge_keys = edges[:, 0] * n_v + edges[:, 1]

    def boundary_nodes(self, tags) -> np.ndarray:
        """Sorted velocity nodes on the faces with `tags`: the faces'
        vertices and edge midpoints."""
        f = np.sort(self.bface_verts[np.isin(self.bface_tag, list(tags))], axis=1)
        pairs = f[:, [[0, 1], [0, 2], [1, 2]]].reshape(-1, 2)
        pos = np.searchsorted(self._edge_keys, pairs[:, 0] * self.n_p + pairs[:, 1])
        if not np.array_equal(self._edge_keys[pos], pairs[:, 0] * self.n_p + pairs[:, 1]):
            raise ValueError("a boundary face's edge is no cell edge")
        return np.unique(np.concatenate([f.reshape(-1), self.n_p + pos]))

    def face_parents(self, faces: np.ndarray):
        """(cell, opposite local vertex) of each boundary face [f, 3]."""
        n_v = np.int64(self.n_p)
        keep = np.array([[j for j in range(4) if j != o] for o in range(4)])
        cf = np.sort(self.cells[:, keep], axis=2).reshape(-1, 3)
        key = lambda t: (t[:, 0] * n_v + t[:, 1]) * n_v + t[:, 2]  # noqa: E731
        ck = key(cf)
        order = np.argsort(ck, kind="stable")
        fk = key(np.sort(faces, axis=1))
        pos = np.searchsorted(ck[order], fk)
        hit = order[np.minimum(pos, len(order) - 1)]
        if not np.array_equal(ck[hit], fk):
            raise ValueError("a boundary face is no cell face")
        return hit // 4, hit % 4

    def match(self, node_coords: np.ndarray) -> np.ndarray:
        """Index of this space's node at each of `node_coords` (the labels
        of an output vector of the program); raises unless every node is
        matched exactly once."""
        mine, theirs = _void_keys(self.node_coords), _void_keys(np.asarray(node_coords, np.float64))
        if mine.shape != theirs.shape:
            raise ValueError(f"{theirs.shape[0]} nodes against the reference's {mine.shape[0]}")
        om, ot = np.argsort(mine, kind="stable"), np.argsort(theirs, kind="stable")
        if not np.array_equal(mine[om], theirs[ot]):
            raise ValueError("the program's nodes are not the reference's")
        out = np.empty(len(ot), np.int64)
        out[ot] = om
        return out

    def match_vertices(self, coords: np.ndarray) -> np.ndarray:
        mine, theirs = _void_keys(self.coords), _void_keys(np.asarray(coords, np.float64))
        om, ot = np.argsort(mine, kind="stable"), np.argsort(theirs, kind="stable")
        if mine.shape != theirs.shape or not np.array_equal(mine[om], theirs[ot]):
            raise ValueError("the program's vertices are not the reference's")
        out = np.empty(len(ot), np.int64)
        out[ot] = om
        return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32's 10-bit mantissa, to nearest."""
    return ((x.view(torch.int32) + (1 << 12)) & -(1 << 13)).view(torch.float32)


class RefOperator:
    """The operators of a P2Space as element passes (gather, one batched
    product a cell, scatter-add), in float64, float32, or "tf32" (float32
    with every product's operands rounded to TF32)."""

    def __init__(self, space: P2Space, dirichlet_tags, precision: str = "float64", device="cpu"):
        self.space = space
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.device = torch.device(device)
        t = reference_tables()
        T = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)  # noqa: E731
        self.cells_u = torch.as_tensor(space.cells_u, device=self.device)
        self.cells_p = torch.as_tensor(space.cells, device=self.device)
        self.n_u, self.n_p = space.n_u, space.n_p
        self.detJ = T(space.detJ)
        self.gradlam = T(space.gradlam)
        self.MHAT = T(t["MHAT"])
        self.CT = T(t["CT"].reshape(40, 100))
        # per-cell stiffness detJ sum_mn (grad l_m . grad l_n) AH[m, n]
        G = np.einsum("emc,enc->emn", space.gradlam, space.gradlam) * space.detJ[:, None, None]
        self.K_e = T(np.einsum("emn,mnij->eij", G, t["AH"]))
        # D_e [E, 4, 10, 3]: (D u)_q = sum_jc D_e[q, j, c] u_jc
        self.D_e = T(np.einsum("qmj,emc->eqjc", t["BH"], space.gradlam) * space.detJ[:, None, None, None])
        diagM = np.zeros(space.n_u)
        np.add.at(diagM, space.cells_u, space.detJ[:, None] * np.diag(t["MHAT"])[None, :])
        mask = np.zeros(space.n_u, dtype=bool)
        mask[space.boundary_nodes(dirichlet_tags)] = True
        self.mask_np = mask
        self.mask = torch.as_tensor(mask, device=self.device)
        self.diagM = T(diagM)
        self.inv1 = T(np.where(mask, 0.0, 1.0 / diagM))

    # the one place products happen ------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            a, b = tf32(a.contiguous()), tf32(b.contiguous())
        return torch.matmul(a, b)

    def T(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # element views ----------------------------------------------------
    def scatter_u(self, y_e: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n_u, y_e.shape[-1]), dtype=self.dtype, device=self.device)
        out.index_add_(0, self.cells_u.reshape(-1), y_e.reshape(-1, y_e.shape[-1]))
        return out

    def scatter_p(self, y_e: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.n_p, dtype=self.dtype, device=self.device)
        out.index_add_(0, self.cells_p.reshape(-1), y_e.reshape(-1))
        return out

    # operators ----------------------------------------------------------
    def mass(self, u: torch.Tensor) -> torch.Tensor:
        y_e = self.mm(self.MHAT, u[self.cells_u]) * self.detJ[:, None, None]
        return self.scatter_u(y_e)

    def F_elements(self, nu: float, dt: float, w: torch.Tensor) -> torch.Tensor:
        """F_e = detJ MHAT / dt + nu K_e + C_e(w): [E, 10, 10]."""
        a = self.mm(w[self.cells_u], self.gradlam.transpose(1, 2))  # [E, k, m] = w_k . grad l_m
        E = a.shape[0]
        C_e = self.mm(a.reshape(E, 40), self.CT).reshape(E, 10, 10) * self.detJ[:, None, None]
        return self.MHAT[None] * (self.detJ / dt)[:, None, None] + nu * self.K_e + C_e

    def apply_elements(self, A_e: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.scatter_u(self.mm(A_e, u[self.cells_u]))

    def div(self, u: torch.Tensor) -> torch.Tensor:
        E = self.D_e.shape[0]
        y_e = self.mm(self.D_e.reshape(E, 4, 30), u[self.cells_u].reshape(E, 30, 1))
        return self.scatter_p(y_e)

    def div_t(self, p: torch.Tensor) -> torch.Tensor:
        """D^T p [n_u, 3] (the weak gradient is its negative)."""
        E = self.D_e.shape[0]
        y_e = self.mm(self.D_e.reshape(E, 4, 30).transpose(1, 2), p[self.cells_p].reshape(E, 4, 1))
        return self.scatter_u(y_e.reshape(E, 10, 3))

    def div_abs(self, u: torch.Tensor) -> torch.Tensor:
        """|D| |u| [n_p]: the divergence pass with every element entry and
        every velocity in absolute value (the divergence without
        cancellation)."""
        E = self.D_e.shape[0]
        y_e = self.mm(self.D_e.reshape(E, 4, 30).abs(), u[self.cells_u].reshape(E, 30, 1).abs())
        return self.scatter_p(y_e)

    def diag_F(self, F_e: torch.Tensor) -> torch.Tensor:
        """The diagonal of F [n_u] from its element matrices F_e."""
        return self.scatter_u(torch.diagonal(F_e, dim1=1, dim2=2)[..., None])[:, 0]

    def diag_S1(self, inv: torch.Tensor | None = None) -> torch.Tensor:
        """diag(D diag(M)^-1_free D^T) from D's assembled entries; with
        `inv` [n_u], diag(D diag(inv) D^T)."""
        E = self.D_e.shape[0]
        rows = self.cells_p[:, :, None, None].expand(E, 4, 10, 3)
        cols = (self.cells_u[:, None, :, None] * 3 + torch.arange(3, device=self.device)).expand(E, 4, 10, 3)
        with warnings.catch_warnings():  # torch warns that it checks no invariants
            warnings.simplefilter("ignore", UserWarning)
            D = torch.sparse_coo_tensor(
                torch.stack([rows.reshape(-1), cols.reshape(-1)]), self.D_e.reshape(-1),
                (self.n_p, 3 * self.n_u),
            ).coalesce()
        r, c = D.indices()
        vals = D.values() ** 2 * (self.inv1 if inv is None else inv)[c // 3]
        out = torch.zeros(self.n_p, dtype=self.dtype, device=self.device)
        return out.index_add_(0, r, vals)
