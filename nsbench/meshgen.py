"""The benchmark's frozen copy of the DFG duct generator.

Copied from the port's `navierstokes_project_nm4pde_tpu_torch/mesh/generators.py`
(`_boundary_edges` :57, `_tag_rect_boundary` :67, `_boundary_tris` :150,
`cylinder_channel_2d` :164, `cylinder_duct_3d` :302, `_split_prisms` :365),
which is itself the JAX package's generator.  The only change: each
function returns the raw arrays (coords, cells, bface_verts, bface_tag)
instead of a `Mesh`, and the 2D channel's triangles get the orientation
fix that the port's `Mesh` applies (`mesh/core.py:59`), since the duct is
extruded from them.  The benchmark hands the same arrays to the port
(`mesh.Mesh(coords, cells, bface_verts, bface_tag)`) and to the reference.
Later changes to the program's generator do not move this yardstick.

Tags: 0 inlet (x = 0), 1 outlet, 2 walls, 3 cylinder.
"""

from __future__ import annotations

import numpy as np


def _oriented_2d(coords: np.ndarray, cells: np.ndarray) -> tuple:
    """(coords float64, cells int32) with every triangle counter-clockwise:
    the last two vertices of a negative one swapped (`mesh/core.py:59-75`)."""
    coords = np.asarray(coords, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int32).copy()
    v = coords[cells]
    det = np.linalg.det(v[:, 1:, :] - v[:, :1, :])
    flip = det < 0.0
    cells[flip, -2], cells[flip, -1] = cells[flip, -1].copy(), cells[flip, -2].copy()
    return coords, cells


def _boundary_edges(cells: np.ndarray) -> np.ndarray:
    """Facets (edges) used by exactly one triangle."""
    edges = np.concatenate(
        [cells[:, [1, 2]], cells[:, [0, 2]], cells[:, [0, 1]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    return uniq[counts == 1]


def _tag_rect_boundary(coords, cells, xmin, xmax, ymin, ymax, obstacle=None):
    eps = 1e-9 * max(xmax - xmin, ymax - ymin)
    edges = _boundary_edges(np.asarray(cells, dtype=np.int64))
    mid = 0.5 * (coords[edges[:, 0]] + coords[edges[:, 1]])
    tag = np.full(edges.shape[0], -1, dtype=np.int32)
    tag[np.abs(mid[:, 0] - xmin) < eps] = 0
    tag[np.abs(mid[:, 0] - xmax) < eps] = 1
    tag[(np.abs(mid[:, 1] - ymin) < eps) | (np.abs(mid[:, 1] - ymax) < eps)] = 2
    if obstacle is not None:
        tag[tag < 0] = 3  # anything else is the obstacle surface
    if np.any(tag < 0):
        raise ValueError("untagged boundary edges")
    return edges.astype(np.int32), tag


def _boundary_tris(cells: np.ndarray) -> np.ndarray:
    c = np.asarray(cells, dtype=np.int64)
    faces = np.concatenate(
        [c[:, [1, 2, 3]], c[:, [0, 2, 3]], c[:, [0, 1, 3]], c[:, [0, 1, 2]]],
        axis=0,
    )
    faces = np.sort(faces, axis=1)
    uniq, counts = np.unique(faces, axis=0, return_counts=True)
    return uniq[counts == 1].astype(np.int32)


def cylinder_channel_2d(
    lc: float = 0.05,
    length: float = 2.2,
    height: float = 0.41,
    cx: float = 0.2,
    cy: float = 0.2,
    radius: float = 0.05,
    refine: float = 0.35,
    smooth_iters: int = 6,
) -> tuple:
    """Unstructured graded triangulation of the DFG 2D benchmark channel.

    Sizing mirrors the reference's gmsh grading (0.65*lc on the cylinder,
    1.5*lc in the far field; ref: mesh/Cylinder2D.geo:1-23): target edge
    length h(x) ramps from ``refine*lc`` at the cylinder to ``lc`` beyond
    the refinement halo.
    """
    from scipy.spatial import Delaunay  # noqa: PLC0415

    h_near = refine * lc
    halo = 6.0 * radius

    def h_of(p):
        d = np.linalg.norm(p - [cx, cy], axis=-1) - radius
        t = np.clip(d / halo, 0.0, 1.0)
        return h_near + (lc - h_near) * t

    pts = []
    fixed = []  # indices of points that must not move (boundary)

    # 1) concentric rings around the cylinder, geometric growth.
    rr = radius
    ring0_n = max(16, int(round(2 * np.pi * radius / h_near)))
    while rr < radius + halo:
        n_ring = max(12, int(round(2 * np.pi * rr / h_of(np.array([cx + rr, cy])))))
        th = np.arange(n_ring) * 2 * np.pi / n_ring
        ring = np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th)], axis=1)
        inside = (
            (ring[:, 0] > 1e-9)
            & (ring[:, 0] < length - 1e-9)
            & (ring[:, 1] > 1e-9)
            & (ring[:, 1] < height - 1e-9)
        )
        if rr == radius:
            fixed.extend(range(len(pts), len(pts) + int(inside.sum())))
        pts.extend(ring[inside])
        rr += h_of(np.array([cx + rr, cy]))

    # 2) outer rectangle boundary points (uniform spacing lc).
    nx = max(2, int(round(length / lc)))
    ny = max(2, int(round(height / lc)))
    xs = np.linspace(0, length, nx + 1)
    ys = np.linspace(0, height, ny + 1)
    for x in xs:
        for y in (0.0, height):
            fixed.append(len(pts))
            pts.append((x, y))
    for y in ys[1:-1]:
        for x in (0.0, length):
            fixed.append(len(pts))
            pts.append((x, y))

    # 3) graded interior grid (keep clear of rings and walls).
    x = 0.5 * lc
    while x < length - 0.25 * lc:
        hx = h_of(np.array([x, cy]))
        y = 0.5 * lc
        col = []
        while y < height - 0.25 * lc:
            p = np.array([x, y])
            hp = h_of(p)
            dc = np.linalg.norm(p - [cx, cy])
            if dc > radius + halo - 0.35 * lc:
                col.append((x, y))
            y += hp
        pts.extend(col)
        x += hx

    pts = np.array(pts, dtype=np.float64)
    fixed = np.array(sorted(set(fixed)), dtype=np.int64)

    def triangulate(p):
        tri = Delaunay(p)
        cells = tri.simplices
        cent = p[cells].mean(axis=1)
        keep = np.linalg.norm(cent - [cx, cy], axis=1) > radius * (1.0 + 1e-9)
        # also drop degenerate slivers
        v = p[cells]
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        keep &= area > 1e-14
        return cells[keep]

    is_fixed = np.zeros(len(pts), dtype=bool)
    is_fixed[fixed] = True

    for _ in range(smooth_iters):
        cells = triangulate(pts)
        # Laplacian smoothing of interior points (average of neighbours).
        e = np.concatenate(
            [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0
        )
        acc = np.zeros_like(pts)
        cnt = np.zeros(len(pts))
        np.add.at(acc, e[:, 0], pts[e[:, 1]])
        np.add.at(acc, e[:, 1], pts[e[:, 0]])
        np.add.at(cnt, e[:, 0], 1)
        np.add.at(cnt, e[:, 1], 1)
        used = cnt > 0
        target = np.where(
            (~is_fixed & used)[:, None], acc / np.maximum(cnt, 1)[:, None], pts
        )
        pts = pts + 0.7 * (target - pts)
        # project stray points out of the cylinder
        d = pts - [cx, cy]
        dist = np.linalg.norm(d, axis=1)
        bad = (dist < radius) & ~is_fixed
        pts[bad] = (
            np.array([cx, cy]) + d[bad] / dist[bad, None] * (radius * 1.001)
        )

    cells = triangulate(pts)
    # Drop points unused by any cell, remap indices.
    used = np.zeros(len(pts), dtype=bool)
    used[cells.ravel()] = True
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(used.sum())
    pts = pts[used]
    cells = remap[cells]

    bf, bt = _tag_rect_boundary(pts, cells, 0.0, length, 0.0, height, obstacle=True)
    coords, cells = _oriented_2d(pts, cells)
    return coords, cells, bf, bt


def cylinder_duct_3d(
    lc: float = 0.05,
    nz: int = 8,
    length: float = 2.5,
    height: float = 0.41,
    cx: float = 0.5,
    cy: float = 0.2,
    radius: float = 0.05,
    refine: float = 0.35,
) -> tuple:
    """Extruded DFG 3D duct: 2.5 x 0.41 x 0.41, cylinder along z at (0.5, 0.2).

    Each triangular prism is split into 3 tets with globally consistent
    diagonals (split driven by global vertex indices), so the mesh conforms.
    Tags: 0=inlet x=0, 1=outlet x=length, 2=walls (y and z extremes),
    3=cylinder surface (ref: mesh/Cylinder3D.geo:126-131).
    """
    base_coords, base_cells, _, _ = cylinder_channel_2d(
        lc=lc, length=length, height=height, cx=cx, cy=cy, radius=radius,
        refine=refine,
    )
    nv2 = base_coords.shape[0]
    zs = np.linspace(0.0, height, nz + 1)
    coords = np.concatenate(
        [
            np.concatenate(
                [base_coords, np.full((nv2, 1), z)], axis=1
            )
            for z in zs
        ],
        axis=0,
    )

    tris = base_cells.astype(np.int64)
    cells = []
    for layer in range(nz):
        lo = layer * nv2
        hi = (layer + 1) * nv2
        a, b, c = tris[:, 0] + lo, tris[:, 1] + lo, tris[:, 2] + lo
        A, B, C = tris[:, 0] + hi, tris[:, 1] + hi, tris[:, 2] + hi
        cells.append(_split_prisms(a, b, c, A, B, C))
    cells = np.concatenate(cells, axis=0).astype(np.int32)

    bf = _boundary_tris(cells)
    mid = coords[bf].mean(axis=1)
    eps = 1e-9
    tag = np.full(bf.shape[0], -1, dtype=np.int32)
    r = np.linalg.norm(mid[:, :2] - [cx, cy], axis=1)
    tag[np.abs(mid[:, 0]) < eps] = 0
    tag[np.abs(mid[:, 0] - length) < eps] = 1
    on_wall = (
        (np.abs(mid[:, 1]) < eps)
        | (np.abs(mid[:, 1] - height) < eps)
        | (np.abs(mid[:, 2]) < eps)
        | (np.abs(mid[:, 2] - height) < eps)
    )
    tag[(tag < 0) & on_wall] = 2
    tag[(tag < 0) & (r < radius * 1.5)] = 3
    if np.any(tag < 0):
        raise ValueError("untagged duct boundary faces")
    return coords, cells, bf, tag


def _split_prisms(a, b, c, A, B, C):
    """Split prisms (bottom a,b,c / top A,B,C) into 3 tets, conforming.

    Uses the classic "indexed diagonal" rule: on each quad side face the
    diagonal starts from the smaller of the two bottom vertex ids, which both
    prisms sharing the face agree on.
    """
    n = a.shape[0]
    out = np.empty((n, 3, 4), dtype=np.int64)
    V = np.stack([a, b, c], axis=1)  # bottom ids
    T = np.stack([A, B, C], axis=1)  # top ids
    # Rotate each prism so the smallest bottom id is first -- the splits
    # below then only depend on the relative order of the other two.
    rot = np.argmin(V, axis=1)
    idx = (np.arange(3)[None, :] + rot[:, None]) % 3
    Vr = np.take_along_axis(V, idx, axis=1)
    Tr = np.take_along_axis(T, idx, axis=1)
    v0, v1, v2 = Vr[:, 0], Vr[:, 1], Vr[:, 2]
    t0, t1, t2 = Tr[:, 0], Tr[:, 1], Tr[:, 2]
    # Quad face (v1,v2,t2,t1): diagonal from min(v1,v2).
    use_v1 = v1 < v2
    # Case A (diag v1-t2): tets (v0,v1,v2,t2), (v0,v1,t2,t1), (v0,t1,t2,t0)
    # Case B (diag v2-t1): tets (v0,v1,v2,t1), (v0,t1,v2,t2), (v0,t1,t2,t0)
    caseA = np.stack(
        [
            np.stack([v0, v1, v2, t2], axis=1),
            np.stack([v0, v1, t2, t1], axis=1),
            np.stack([v0, t1, t2, t0], axis=1),
        ],
        axis=1,
    )
    caseB = np.stack(
        [
            np.stack([v0, v1, v2, t1], axis=1),
            np.stack([v0, t1, v2, t2], axis=1),
            np.stack([v0, t1, t2, t0], axis=1),
        ],
        axis=1,
    )
    out = np.where(use_v1[:, None, None], caseA, caseB)
    return out.reshape(-1, 4)


# Each generator's dimension: the harness reads it, before any mesh is
# built, to refuse a configuration that the correctness check does not cover.
DIMENSION = {"cylinder_channel_2d": 2, "cylinder_duct_3d": 3}
