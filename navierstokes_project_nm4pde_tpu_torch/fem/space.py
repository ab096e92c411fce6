"""Taylor-Hood (P2-P1) function space on a simplex mesh.

The port's copy of the JAX package's `fem/space.py` (numpy only).

Replaces deal.II's `FESystem(FE_SimplexP(2)^dim, FE_SimplexP(1))` +
`DoFHandler` + block renumbering (ref: src/NavierStokes2D.cpp:31-93).

TPU-native DoF model: there is no distributed index set -- DoFs are plain
array axes.  Velocity DoFs live as `[n_unodes, dim]` arrays (one scalar P2
node set shared by all velocity components -- the reference's block
renumbering collapses to array shape), pressure DoFs as `[n_pnodes]` with
`n_pnodes == n_vertices`.  Cell->DoF maps are static int32 arrays consumed by
gather/segment-sum kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from navierstokes_project_nm4pde_tpu_torch.fem import reference as ref
from navierstokes_project_nm4pde_tpu_torch.mesh.core import Mesh


def _local_edges(dim: int):
    return ref.TRI_EDGES if dim == 2 else ref.TET_EDGES


def _pack_pairs(pairs: np.ndarray, n: int) -> np.ndarray:
    p = np.sort(pairs.astype(np.int64), axis=1)
    return p[:, 0] * np.int64(n) + p[:, 1]


@dataclasses.dataclass
class TaylorHoodSpace:
    mesh: Mesh
    edges: np.ndarray  # [n_edges, 2] int32 (sorted vertex pairs)
    cells_u: np.ndarray  # [n_c, n_loc_u] int32 P2 node ids per cell
    cells_p: np.ndarray  # [n_c, dim+1] int32 (vertex ids)
    unode_coords: np.ndarray  # [n_unodes, dim] float64
    bface_cell: np.ndarray  # [n_bf] parent cell of each boundary facet
    bface_local: np.ndarray  # [n_bf] local facet index in parent
    bface_unodes: np.ndarray  # [n_bf, n_face_u] P2 node ids on each facet
    bface_pnodes: np.ndarray  # [n_bf, dim] vertex ids on each facet

    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def n_unodes(self) -> int:
        return self.unode_coords.shape[0]

    @property
    def n_pnodes(self) -> int:
        return self.mesh.n_vertices

    @property
    def n_udofs(self) -> int:
        return self.n_unodes * self.dim

    @property
    def n_dofs(self) -> int:
        return self.n_udofs + self.n_pnodes

    @property
    def n_loc_u(self) -> int:
        return ref.n_p2_nodes(self.dim)

    # ------------------------------------------------------------------
    def boundary_unodes(self, tags) -> np.ndarray:
        """Sorted unique P2 node ids lying on facets with the given tags."""
        tags = np.atleast_1d(np.asarray(tags))
        sel = np.isin(self.mesh.bface_tag, tags)
        return np.unique(self.bface_unodes[sel])

    def dirichlet_mask(self, tags) -> np.ndarray:
        """Boolean [n_unodes] mask of velocity nodes constrained on `tags`.

        Mirrors `interpolate_boundary_values` with the velocity-only component
        mask (ref: src/NavierStokes2D.cpp:328-355): all velocity components of
        a boundary node are constrained, pressure never is.
        """
        mask = np.zeros(self.n_unodes, dtype=bool)
        mask[self.boundary_unodes(tags)] = True
        return mask


def build_taylor_hood(mesh: Mesh) -> TaylorHoodSpace:
    dim = mesh.dim
    cells = mesh.cells.astype(np.int64)
    n_v = mesh.n_vertices
    loc_edges = np.array(_local_edges(dim), dtype=np.int64)  # [n_le, 2]

    # --- unique edges and per-cell edge ids (native meshkit or numpy) -----
    from navierstokes_project_nm4pde_tpu_torch.mesh.native import build_edges

    edges, edge_ids = build_edges(cells, loc_edges, n_v)

    # First-touch edge renumbering: with spatially sorted cells this keeps
    # each cell block's edge-node ids in a tight window (sorted-key edge
    # numbering follows the *first* vertex and spreads ~7x wider), which is
    # what windowed gathers and plan locality live on.
    flat_e = edge_ids.reshape(-1)
    uniq_e, first_pos = np.unique(flat_e, return_index=True)
    appearance = uniq_e[np.argsort(first_pos, kind="stable")]
    new_of_old = np.empty(edges.shape[0], dtype=np.int64)
    new_of_old[appearance] = np.arange(len(appearance))
    edge_ids = new_of_old[edge_ids]
    old_of_new = np.empty_like(new_of_old)
    old_of_new[new_of_old] = np.arange(len(new_of_old))
    edges = edges[old_of_new]

    # sorted-key lookup table for boundary-facet edge resolution
    sort_keys = (
        edges[:, 0].astype(np.int64) * np.int64(n_v) + edges[:, 1]
    )
    key_order = np.argsort(sort_keys, kind="stable")
    sorted_keys = sort_keys[key_order]

    cells_u = np.concatenate([cells, n_v + edge_ids], axis=1).astype(np.int32)

    unode_coords = np.concatenate(
        [
            mesh.coords,
            0.5 * (mesh.coords[edges[:, 0]] + mesh.coords[edges[:, 1]]),
        ],
        axis=0,
    )

    # --- boundary facets ---------------------------------------------------
    bcell, blocal = mesh.boundary_face_parents()
    bfv = np.sort(mesh.bface_verts.astype(np.int64), axis=1)  # [n_bf, dim]
    if dim == 2:
        face_edge_pairs = bfv[:, None, :]  # one edge per facet
    else:
        face_edge_pairs = bfv[:, [[0, 1], [0, 2], [1, 2]]]  # [n_bf, 3, 2]
    fkeys = _pack_pairs(face_edge_pairs.reshape(-1, 2), n_v)
    pos = np.searchsorted(sorted_keys, fkeys)
    if not np.all(sorted_keys[np.minimum(pos, len(sorted_keys) - 1)] == fkeys):
        raise ValueError("boundary facet edge not found in cell edges")
    face_edge_ids = key_order[pos].reshape(bfv.shape[0], -1)
    bface_unodes = np.concatenate([bfv, n_v + face_edge_ids], axis=1).astype(
        np.int32
    )

    return TaylorHoodSpace(
        mesh=mesh,
        edges=edges,
        cells_u=cells_u,
        cells_p=mesh.cells.astype(np.int32),
        unode_coords=unode_coords,
        bface_cell=bcell.astype(np.int32),
        bface_local=blocal.astype(np.int32),
        bface_unodes=bface_unodes,
        bface_pnodes=bfv.astype(np.int32),
    )
