"""The benchmark's meshes: a frozen numpy copy of the box generators.

Structured hexahedral boxes split into six Kuhn tetrahedra each, promoted
to quadratic c3d10 tetrahedra by one node at the middle of every edge,
and the plane selector that picks the nodes of a face.  The arithmetic is
that of tpufem's ``utils.meshgen`` (``box_hex``, ``box_tet``,
``tet4_to_tet10``, ``boundary_nodes``), copied here so that a later change
to the program cannot move the benchmark's inputs; the unique edge list is
``np.unique`` on one int64 key per edge, which orders edges as the
program's radix sort does.  Host numpy only: nothing here imports torch or
the program.
"""
from __future__ import annotations

import numpy as np

GENERATORS = ("box_tet10",)


def box_hex(nx: int, ny: int, nz: int, lx=1.0, ly=1.0, lz=1.0):
    """(coords [N, 3] float64, conn [M, 8] int32), c3d8 node order."""
    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    zs = np.linspace(0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    conn = np.stack([
        nid(I, J, K), nid(I + 1, J, K), nid(I + 1, J + 1, K), nid(I, J + 1, K),
        nid(I, J, K + 1), nid(I + 1, J, K + 1), nid(I + 1, J + 1, K + 1),
        nid(I, J + 1, K + 1),
    ], axis=1)
    return coords, conn.astype(np.int32)


_KUHN_TETS = np.array([
    [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
    [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6],
])
_TET_EDGES = np.array([[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]])


def box_tet(nx: int, ny: int, nz: int, lx=1.0, ly=1.0, lz=1.0):
    """Six positively oriented Kuhn tetrahedra per hexahedron."""
    coords, hexes = box_hex(nx, ny, nz, lx, ly, lz)
    tets = hexes[:, _KUHN_TETS].reshape(-1, 4)
    # every cell is the same box, so one sign per sub-tet fixes them all
    p = coords[tets[:6]]
    neg = np.linalg.det(p[:, 1:4] - p[:, 0:1]) < 0
    flip = np.tile(neg, tets.shape[0] // 6)
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]
    return coords, tets.astype(np.int32)


def tet4_to_tet10(coords, conn):
    """c3d4 -> c3d10: edge nodes on edges 01, 12, 20, 03, 13, 23, one new
    node per unique edge, appended in the order of the sorted edge keys."""
    M = conn.shape[0]
    edges = np.sort(conn[:, _TET_EDGES].reshape(-1, 2), axis=1)
    base = coords.shape[0]
    key = edges[:, 0].astype(np.int64) * np.int64(base) + edges[:, 1]
    uniq_key, inv = np.unique(key, return_inverse=True)
    a, b = uniq_key // base, uniq_key % base
    new_coords = np.concatenate([coords, 0.5 * (coords[a] + coords[b])],
                                axis=0)
    mid = (base + inv.reshape(-1)).reshape(M, 6)
    return new_coords, np.concatenate([conn, mid], axis=1).astype(np.int32)


def box_tet10(nx, ny, nz, lx=1.0, ly=1.0, lz=1.0):
    return tet4_to_tet10(*box_tet(nx, ny, nz, lx, ly, lz))


def boundary_nodes(coords, axis: int = 0, value: float = 0.0, tol=1e-9):
    """Ids of the nodes on the plane coords[:, axis] == value."""
    return np.nonzero(np.abs(coords[:, axis] - value) < tol)[0].astype(
        np.int32)


def sizes(n) -> tuple:
    """(elements, nodes) of box_tet10(*n), from the counts alone: every
    point of the half-step lattice is a corner or the middle of an edge."""
    nx, ny, nz = n
    return 6 * nx * ny * nz, (2 * nx + 1) * (2 * ny + 1) * (2 * nz + 1)


def make(mesh: dict):
    """(coords, conn) of a configuration's "mesh" entry."""
    if mesh["generator"] not in GENERATORS:
        raise ValueError(f"unknown mesh generator {mesh['generator']!r}")
    return box_tet10(*mesh["n"], *mesh["size"])
