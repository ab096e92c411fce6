"""gmsh `.msh` reader (ASCII and binary, v2.2 and v4.1): the port's copy
of the reader side of the JAX package's `mesh/msh_io.py`.

Replaces deal.II's `GridIn::read_msh` (ref: src/NavierStokes2D.cpp:10-14),
which accepts both ASCII and binary gmsh files.  Reads linear simplices
(triangles/tets) plus the tagged boundary facets (lines in 2D, triangles
in 3D); the physical tag of each facet becomes `Mesh.bface_tag`, matching
the reference's boundary-id scheme.
"""

from __future__ import annotations

import numpy as np

from navierstokes_project_nm4pde_tpu_torch.mesh.core import Mesh

# gmsh element type ids
_LINE = 1
_TRI = 2
_TET = 4
_NNODE = {_LINE: 2, _TRI: 3, _TET: 4}


def read_msh(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    # $MeshFormat: "version file-type data-size"; file-type 1 = binary.
    head = data.split(b"\n", 3)
    if not head or head[0].strip() != b"$MeshFormat":
        raise ValueError(f"{path}: not a gmsh .msh file")
    fmt = head[1].split()
    version = float(fmt[0])
    binary = len(fmt) > 1 and int(fmt[1]) == 1

    nodes = {}
    elements = []  # (etype, phys_tag, [node ids])
    ent_phys = {}  # (entity_dim, entity_tag) -> physical tag  (v4.x only)
    if binary:
        _read_msh_binary(data, version, nodes, elements, ent_phys)
    else:
        lines = data.decode("utf-8", errors="replace").splitlines()
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            if line == "$MeshFormat":
                i += 3
            elif line == "$Entities":
                i = _read_entities_v4(lines, i + 1, ent_phys, version)
            elif line == "$Nodes":
                if version >= 4.0:
                    i = _read_nodes_v4(lines, i + 1, nodes)
                else:
                    i = _read_nodes_v2(lines, i + 1, nodes)
            elif line == "$Elements":
                if version >= 4.0:
                    i = _read_elements_v4(lines, i + 1, elements, ent_phys)
                else:
                    i = _read_elements_v2(lines, i + 1, elements)
            else:
                i += 1

    if not nodes:
        raise ValueError(f"no nodes found in {path}")

    # Compact node numbering.
    ids = np.array(sorted(nodes.keys()), dtype=np.int64)
    remap = {int(g): k for k, g in enumerate(ids)}
    coords3 = np.array([nodes[int(g)] for g in ids], dtype=np.float64)

    tets = [(t, n) for (e, t, n) in elements if e == _TET]
    tris = [(t, n) for (e, t, n) in elements if e == _TRI]
    lns = [(t, n) for (e, t, n) in elements if e == _LINE]

    if tets:
        dim = 3
        cells = np.array([n for _, n in tets], dtype=np.int64)
        bf = np.array([n for _, n in tris], dtype=np.int64).reshape(-1, 3)
        bt = np.array([t for t, _ in tris], dtype=np.int32)
    elif tris:
        dim = 2
        cells = np.array([n for _, n in tris], dtype=np.int64)
        bf = np.array([n for _, n in lns], dtype=np.int64).reshape(-1, 2)
        bt = np.array([t for t, _ in lns], dtype=np.int32)
    else:
        raise ValueError(f"no volume elements in {path}")

    conv = np.vectorize(lambda g: remap[int(g)], otypes=[np.int64])
    cells = conv(cells)
    bf = conv(bf) if bf.size else bf.astype(np.int64)
    coords = coords3[:, :dim]
    mesh = Mesh(coords, cells.astype(np.int32), bf.astype(np.int32), bt)
    # Keep only facets that are actually on the boundary (gmsh files may tag
    # interior surfaces too).
    try:
        mesh.check_boundary_closed()
    except ValueError:
        keys_all, _, _ = mesh._all_facets()
        k = Mesh._facet_keys(keys_all)
        uniq, counts = np.unique(k, return_counts=True)
        bnd = set(uniq[counts == 1].tolist())
        bk = Mesh._facet_keys(np.sort(mesh.bface_verts, axis=1))
        keep = np.array([kk in bnd for kk in bk.tolist()])
        mesh = Mesh(coords, mesh.cells, mesh.bface_verts[keep], mesh.bface_tag[keep])
    return mesh


class _BinCursor:
    """Sequential reader over a gmsh binary .msh byte buffer (mixed ASCII
    section markers + packed little-endian records)."""

    def __init__(self, data: bytes, off: int = 0):
        self.d = data
        self.o = off

    def line(self) -> str:
        j = self.d.index(b"\n", self.o)
        s = self.d[self.o:j].decode("utf-8", "replace").strip()
        self.o = j + 1
        return s

    def skip_ws(self):
        while self.o < len(self.d) and self.d[self.o] in b" \r\n\t":
            self.o += 1

    def read(self, dtype, n: int) -> np.ndarray:
        a = np.frombuffer(self.d, dtype=dtype, count=n, offset=self.o)
        self.o += a.nbytes
        return a


def _read_msh_binary(data, version, nodes, elements, ent_phys):
    """Binary v2.2 / v4.1 (little-endian; deal.II's read_msh accepts the
    same binary files, ref: src/NavierStokes2D.cpp:10-14)."""
    cur = _BinCursor(data, 0)
    assert cur.line() == "$MeshFormat"
    fmt = cur.line().split()
    dsize = int(fmt[2]) if len(fmt) > 2 else 8
    one = int(cur.read(np.int32, 1)[0])
    if one != 1:
        raise ValueError("big-endian binary .msh is not supported")
    szt = np.int64 if dsize == 8 else np.int32
    cur.skip_ws()
    assert cur.line() == "$EndMeshFormat"

    while True:
        cur.skip_ws()
        if cur.o >= len(cur.d):
            break
        sec = cur.line()
        if sec == "$Entities" and version >= 4.0:
            cnts = [int(x) for x in cur.read(szt, 4)]
            for _ in range(cnts[0]):  # points: tag, xyz, phys
                tag = int(cur.read(np.int32, 1)[0])
                cur.read(np.float64, 3)
                nph = int(cur.read(szt, 1)[0])
                phys = cur.read(np.int32, nph)
                if nph:
                    ent_phys[(0, tag)] = int(phys[0])
            for dim in (1, 2, 3):
                for _ in range(cnts[dim]):  # tag, bbox, phys, bounding
                    tag = int(cur.read(np.int32, 1)[0])
                    cur.read(np.float64, 6)
                    nph = int(cur.read(szt, 1)[0])
                    phys = cur.read(np.int32, nph)
                    if nph:
                        ent_phys[(dim, tag)] = int(phys[0])
                    nb = int(cur.read(szt, 1)[0])
                    cur.read(np.int32, nb)
            cur.skip_ws()
            assert cur.line() == "$EndEntities"
        elif sec == "$Nodes":
            if version >= 4.0:
                nb_, _nn, _mn, _mx = (int(x) for x in cur.read(szt, 4))
                for _ in range(nb_):
                    cur.read(np.int32, 3)  # entityDim, entityTag, parametric
                    num = int(cur.read(szt, 1)[0])
                    tags = cur.read(szt, num)
                    xyz = cur.read(np.float64, 3 * num).reshape(num, 3)
                    for t, p in zip(tags, xyz):
                        nodes[int(t)] = (p[0], p[1], p[2])
            else:
                num = int(cur.line().split()[0])
                rec = cur.read(np.uint8, num * 28).reshape(num, 28)
                ids = rec[:, :4].copy().view(np.int32).ravel()
                xyz = rec[:, 4:].copy().view(np.float64).reshape(num, 3)
                for t, p in zip(ids, xyz):
                    nodes[int(t)] = (p[0], p[1], p[2])
            cur.skip_ws()
            assert cur.line() == "$EndNodes"
        elif sec == "$Elements":
            if version >= 4.0:
                nb_, _ne, _mn, _mx = (int(x) for x in cur.read(szt, 4))
                for _ in range(nb_):
                    edim, etag, etype = (int(x) for x in cur.read(np.int32, 3))
                    num = int(cur.read(szt, 1)[0])
                    nn = _NNODE.get(etype)
                    if nn is None:
                        raise ValueError(
                            f"unsupported element type {etype} in binary .msh"
                        )
                    rec = cur.read(szt, num * (1 + nn)).reshape(num, 1 + nn)
                    tag = ent_phys.get((edim, etag), etag)
                    for r in rec:
                        elements.append((etype, tag, [int(x) for x in r[1:]]))
            else:
                ne = int(cur.line().split()[0])
                done = 0
                while done < ne:
                    etype, num, ntags = (
                        int(x) for x in cur.read(np.int32, 3)
                    )
                    nn = _NNODE.get(etype)
                    if nn is None:
                        raise ValueError(
                            f"unsupported element type {etype} in binary .msh"
                        )
                    rec = cur.read(
                        np.int32, num * (1 + ntags + nn)
                    ).reshape(num, 1 + ntags + nn)
                    for r in rec:
                        phys = int(r[1]) if ntags >= 1 else 0
                        elements.append(
                            (etype, phys, [int(x) for x in r[1 + ntags:]])
                        )
                    done += num
            cur.skip_ws()
            assert cur.line() == "$EndElements"
        elif sec.startswith("$End"):
            continue
        elif sec.startswith("$"):
            # unknown section: skip to its end marker
            endm = ("$End" + sec[1:]).encode()
            j = data.find(endm, cur.o)
            if j < 0:
                break
            cur.o = j + len(endm)
        # stray text between sections: ignore


def _read_nodes_v2(lines, i, nodes):
    n = int(lines[i].split()[0])
    for k in range(n):
        parts = lines[i + 1 + k].split()
        nodes[int(parts[0])] = (float(parts[1]), float(parts[2]), float(parts[3]))
    i += 1 + n
    assert lines[i].strip() == "$EndNodes"
    return i + 1


def _read_elements_v2(lines, i, elements):
    n = int(lines[i].split()[0])
    for k in range(n):
        parts = lines[i + 1 + k].split()
        etype = int(parts[1])
        ntags = int(parts[2])
        phys = int(parts[3]) if ntags >= 1 else 0
        node_ids = [int(x) for x in parts[3 + ntags:]]
        elements.append((etype, phys, node_ids))
    i += 1 + n
    assert lines[i].strip() == "$EndElements"
    return i + 1


def _read_nodes_v4(lines, i, nodes):
    header = lines[i].split()
    num_blocks = int(header[0])
    i += 1
    for _ in range(num_blocks):
        _, _, _, num = (int(x) for x in lines[i].split())
        tags = [int(lines[i + 1 + k]) for k in range(num)]
        for k in range(num):
            parts = lines[i + 1 + num + k].split()
            nodes[tags[k]] = (float(parts[0]), float(parts[1]), float(parts[2]))
        i += 1 + 2 * num
    assert lines[i].strip() == "$EndNodes"
    return i + 1


def _read_entities_v4(lines, i, ent_phys, version=4.1):
    """Parse $Entities: map (entityDim, entityTag) -> first physical tag.

    gmsh v4.x element blocks carry only *geometric* entity tags; the
    physical (boundary-id) tags live here.  deal.II's read_msh (what the
    reference loads meshes with, ref: src/NavierStokes2D.cpp:10-14) keys
    boundary ids off the physical groups, so we must too."""
    counts = [int(x) for x in lines[i].split()]  # points curves surfaces volumes
    i += 1
    for dim, cnt in enumerate(counts):
        for _ in range(cnt):
            parts = lines[i].split()
            tag = int(parts[0])
            # v4.1 points: tag x y z; v4.0 points carry a full min/max
            # bounding box like higher-dim entities; higher dims: tag + bbox
            if dim == 0:
                off = 4 if (version is None or version >= 4.1) else 7
            else:
                off = 7
            nphys = int(parts[off])
            if nphys >= 1:
                ent_phys[(dim, tag)] = int(parts[off + 1])
            i += 1
    assert lines[i].strip() == "$EndEntities"
    return i + 1


def _read_elements_v4(lines, i, elements, ent_phys):
    header = lines[i].split()
    num_blocks = int(header[0])
    i += 1
    for _ in range(num_blocks):
        ent_dim, ent_tag, etype, num = (int(x) for x in lines[i].split())
        tag = ent_phys.get((ent_dim, ent_tag), ent_tag)
        for k in range(num):
            parts = [int(x) for x in lines[i + 1 + k].split()]
            elements.append((etype, tag, parts[1:]))
        i += 1 + num
    assert lines[i].strip() == "$EndElements"
    return i + 1

