"""VTU (VTK XML unstructured grid) field export: a copy of the reference's
`io/vtu.py` (numpy only), held equal to it by
tests/test_torch_port_copies.py.  The port keeps its own copy instead of
importing it.

Binary-appended VTU with the quadratic cell types (VTK_QUADRATIC_TRIANGLE=22
/ VTK_QUADRATIC_TETRA=24), so the P2 velocity is exported losslessly at
every P2 node, the P1 pressure is prolonged to the P2 nodes, and an
optional `partitioning` cell field marks subdomains.  A `.pvd` collection
file indexes the time series.
"""

from __future__ import annotations

import base64
import os
import struct

import numpy as np

# VTK node orderings for quadratic simplices match our P2 ordering up to the
# edge permutation below (VTK: edges (0,1),(1,2),(2,0) for tri;
# (0,1),(1,2),(0,2),(0,3),(1,3),(2,3) for tet -- ours is lexicographic).
_TRI_EDGE_PERM = [0, 2, 1]  # ours (0,1),(0,2),(1,2) -> VTK (0,1),(1,2),(0,2)...
_VTK_TRI6_ORDER = None  # computed below


def _vtk_cell_order(dim: int):
    if dim == 2:
        # VTK_QUADRATIC_TRIANGLE: v0 v1 v2, then midpoints of (0,1),(1,2),(2,0)
        # ours: v0 v1 v2, then (0,1),(0,2),(1,2)
        return [0, 1, 2, 3 + 0, 3 + 2, 3 + 1]
    # VTK_QUADRATIC_TETRA: v0..v3, then (0,1),(1,2),(0,2),(0,3),(1,3),(2,3)
    # ours: v0..v3, then (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)
    return [0, 1, 2, 3, 4 + 0, 4 + 3, 4 + 1, 4 + 2, 4 + 4, 4 + 5]


def _b64_block(data: bytes) -> str:
    header = struct.pack("<I", len(data))
    return base64.b64encode(header + data).decode("ascii")


def write_vtu(
    path: str,
    space,
    u: np.ndarray,
    p: np.ndarray,
    partitioning: np.ndarray | None = None,
):
    """Write one VTU snapshot.

    Args:
      space: TaylorHoodSpace
      u: [n_unodes, dim] velocity at P2 nodes
      p: [n_pnodes] pressure at vertices (prolonged to edges for output)
    """
    dim = space.dim
    u = np.asarray(u, dtype=np.float32)
    p = np.asarray(p, dtype=np.float64)
    coords = space.unode_coords
    n_pts = coords.shape[0]
    # pad coordinates and vectors to 3 components (VTK requirement)
    pts3 = np.zeros((n_pts, 3), dtype=np.float32)
    pts3[:, :dim] = coords
    u3 = np.zeros((n_pts, 3), dtype=np.float32)
    u3[:, :dim] = u
    # prolong P1 pressure to edge nodes
    p_full = np.empty(n_pts, dtype=np.float32)
    p_full[: space.n_pnodes] = p
    e = space.edges
    p_full[space.n_pnodes:] = 0.5 * (p[e[:, 0]] + p[e[:, 1]])

    order = _vtk_cell_order(dim)
    conn = space.cells_u[:, order].astype(np.int64)
    part = (
        np.asarray(partitioning, dtype=np.float32)
        if partitioning is not None else None
    )
    _write_vtu_piece(path, dim, pts3, u3, p_full, conn, part)


def _write_vtu_piece(
    path: str,
    dim: int,
    pts3: np.ndarray,
    u3: np.ndarray,
    p_full: np.ndarray,
    conn: np.ndarray,
    part: np.ndarray | None,
):
    n_pts = pts3.shape[0]
    n_cells, n_loc = conn.shape
    offsets = (np.arange(1, n_cells + 1, dtype=np.int64)) * n_loc
    ctype = 22 if dim == 2 else 24
    types = np.full(n_cells, ctype, dtype=np.uint8)

    blocks = {
        "points": pts3.tobytes(),
        "conn": conn.tobytes(),
        "offsets": offsets.tobytes(),
        "types": types.tobytes(),
        "velocity": u3.tobytes(),
        "pressure": p_full.tobytes(),
    }
    cell_fields = ""
    if part is not None:
        blocks["partitioning"] = part.tobytes()
        cell_fields = (
            '<DataArray type="Float32" Name="partitioning" format="binary">'
            + _b64_block(blocks["partitioning"])
            + "</DataArray>"
        )

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
  <UnstructuredGrid>
    <Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">
      <Points>
        <DataArray type="Float32" NumberOfComponents="3" format="binary">{_b64_block(blocks['points'])}</DataArray>
      </Points>
      <Cells>
        <DataArray type="Int64" Name="connectivity" format="binary">{_b64_block(blocks['conn'])}</DataArray>
        <DataArray type="Int64" Name="offsets" format="binary">{_b64_block(blocks['offsets'])}</DataArray>
        <DataArray type="UInt8" Name="types" format="binary">{_b64_block(blocks['types'])}</DataArray>
      </Cells>
      <PointData Vectors="velocity">
        <DataArray type="Float32" Name="velocity" NumberOfComponents="3" format="binary">{_b64_block(blocks['velocity'])}</DataArray>
        <DataArray type="Float32" Name="pressure" format="binary">{_b64_block(blocks['pressure'])}</DataArray>
      </PointData>
      <CellData>{cell_fields}</CellData>
    </Piece>
  </UnstructuredGrid>
</VTKFile>
"""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(xml)


def write_vtu_with_pvtu_record(
    dirname: str,
    basename: str,
    space,
    u: np.ndarray,
    p: np.ndarray,
    n_pieces: int = 1,
    partitioning: np.ndarray | None = None,
) -> str:
    """Multi-file parallel VTK record: `basename_000i.vtu` piece files plus
    a `basename.pvtu` master referencing them.

    The single-host counterpart of deal.II's
    `DataOut::write_vtu_with_pvtu_record` (ref:
    src/NavierStokes2D.cpp:669-675): each piece holds one subdomain's
    cells with its referenced points renumbered locally, the master
    declares the shared schema, and a `partitioning` cell field colours
    pieces like the reference's subdomain field.  Pieces follow the
    per-cell `partitioning` array when given (e.g. the cell-sharding
    split), else a contiguous equal split.  Returns the .pvtu path."""
    dim = space.dim
    u = np.asarray(u, dtype=np.float32)
    p = np.asarray(p, dtype=np.float64)
    coords = space.unode_coords
    n_pts = coords.shape[0]
    pts3 = np.zeros((n_pts, 3), dtype=np.float32)
    pts3[:, :dim] = coords
    u3 = np.zeros((n_pts, 3), dtype=np.float32)
    u3[:, :dim] = u
    p_full = np.empty(n_pts, dtype=np.float32)
    p_full[: space.n_pnodes] = p
    e = space.edges
    p_full[space.n_pnodes:] = 0.5 * (p[e[:, 0]] + p[e[:, 1]])

    order = _vtk_cell_order(dim)
    conn = space.cells_u[:, order].astype(np.int64)
    n_cells = conn.shape[0]
    if partitioning is None:
        owner = np.minimum(
            np.arange(n_cells) * n_pieces // max(n_cells, 1), n_pieces - 1
        )
    else:
        owner = np.asarray(partitioning, dtype=np.int64)
        n_pieces = int(owner.max()) + 1 if n_cells else n_pieces

    os.makedirs(os.path.abspath(dirname), exist_ok=True)
    piece_files = []
    for i in range(n_pieces):
        conn_i = conn[owner == i]
        used = np.unique(conn_i)
        remap = np.zeros(n_pts, dtype=np.int64)
        remap[used] = np.arange(used.size)
        fname = f"{basename}_{i:04d}.vtu"
        _write_vtu_piece(
            os.path.join(dirname, fname),
            dim,
            pts3[used],
            u3[used],
            p_full[used],
            remap[conn_i],
            np.full(conn_i.shape[0], float(i), dtype=np.float32),
        )
        piece_files.append(fname)

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="PUnstructuredGrid" version="0.1" '
        'byte_order="LittleEndian">',
        '  <PUnstructuredGrid GhostLevel="0">',
        "    <PPoints>",
        '      <PDataArray type="Float32" NumberOfComponents="3"/>',
        "    </PPoints>",
        '    <PPointData Vectors="velocity">',
        '      <PDataArray type="Float32" Name="velocity" '
        'NumberOfComponents="3"/>',
        '      <PDataArray type="Float32" Name="pressure"/>',
        "    </PPointData>",
        "    <PCellData>",
        '      <PDataArray type="Float32" Name="partitioning"/>',
        "    </PCellData>",
    ]
    lines += [f'    <Piece Source="{f}"/>' for f in piece_files]
    lines += ["  </PUnstructuredGrid>", "</VTKFile>"]
    pvtu_path = os.path.join(dirname, basename + ".pvtu")
    with open(pvtu_path, "w") as f:
        f.write("\n".join(lines))
    return pvtu_path


def write_pvd(path: str, entries):
    """Write a ParaView collection file: entries = [(time, vtu_path), ...]."""
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
        "  <Collection>",
    ]
    for t, fp in entries:
        lines.append(
            f'    <DataSet timestep="{t}" group="" part="0" file="{os.path.basename(fp)}"/>'
        )
    lines += ["  </Collection>", "</VTKFile>"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
