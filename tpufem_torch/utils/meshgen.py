"""Structured box meshes (host-side numpy), copied from tpufem.utils.meshgen.

The hex box, its Kuhn tet split, its wedge split, the second-order
promotions (c3d4 -> c3d10, c3d8 -> c3d20, c3d6 -> c3d15), the flat s4 and
s3 shell grids and the face selector for fixing nodes.  Outputs are
bitwise equal to tpufem's.
"""
from __future__ import annotations

import numpy as np


def box_hex(nx: int, ny: int, nz: int, lx=1.0, ly=1.0, lz=1.0):
    """Structured hexahedral box mesh.

    Returns (coords [N,3] float64, conn [M,8] int32) with c3d8 node ordering:
    bottom quad counter-clockwise, then the top quad.
    """
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


def box_tet(nx: int, ny: int, nz: int, lx=1.0, ly=1.0, lz=1.0):
    """Conforming tetrahedral box mesh (Kuhn 6-tet split of each hex)."""
    coords, hexes = box_hex(nx, ny, nz, lx, ly, lz)
    tets = hexes[:, _KUHN_TETS].reshape(-1, 4)
    # every cell is the same axis-aligned box, so the orientation sign of
    # sub-tet i is identical across cells: fix the 6-tet pattern once
    pattern = tets[:6]
    p = coords[pattern]
    neg = np.linalg.det(p[:, 1:4] - p[:, 0:1]) < 0
    flip = np.tile(neg, tets.shape[0] // 6)
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]
    return coords, tets.astype(np.int32)


def box_wedge(nx: int, ny: int, nz: int, lx=1.0, ly=1.0, lz=1.0):
    """Conforming wedge box mesh (2 wedges per hex, split along 0-2)."""
    coords, hexes = box_hex(nx, ny, nz, lx, ly, lz)
    w1 = hexes[:, [0, 1, 2, 4, 5, 6]]
    w2 = hexes[:, [0, 2, 3, 4, 6, 7]]
    return coords, np.concatenate([w1, w2], axis=0).astype(np.int32)


def unique_rows2(rows, base: int | None = None):
    """`np.unique(rows, axis=0, return_inverse=True)` for [E, 2] int rows.

    Encodes each row as one int64 key (`a * base + b`) so the unique runs on
    a scalar (native radix) sort.  Ordering is identical to the axis=0 form
    as long as `base > rows.max()`.
    """
    from .. import native

    rows = np.asarray(rows)
    if base is None:
        base = int(rows.max()) + 1 if rows.size else 1
    key = rows[:, 0].astype(np.int64) * np.int64(base) + rows[:, 1]
    nat = native.unique_inverse_i64(key) if key.size else None
    if nat is not None:
        uniq_key, inv = nat
    else:
        uniq_key, inv = np.unique(key, return_inverse=True)
    uniq = np.stack([uniq_key // base, uniq_key % base], axis=1)
    return uniq.astype(rows.dtype, copy=False), inv


def _unique_edge_midpoints(coords, edges_flat):
    """Insert unique midpoints for an [E,2] edge list.

    Returns (new_coords, mid_index[E] into new_coords).
    """
    e_sorted = np.sort(edges_flat, axis=1)
    uniq, inv = unique_rows2(e_sorted, coords.shape[0])
    mids = 0.5 * (coords[uniq[:, 0]] + coords[uniq[:, 1]])
    new_coords = np.concatenate([coords, mids], axis=0)
    return new_coords, coords.shape[0] + inv


_TET_EDGES = np.array([[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]])
_HEX20_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0],
                         [4, 5], [5, 6], [6, 7], [7, 4],
                         [0, 4], [1, 5], [2, 6], [3, 7]])
_WEDGE15_EDGES = np.array([[0, 1], [1, 2], [2, 0],
                           [3, 4], [4, 5], [5, 3],
                           [0, 3], [1, 4], [2, 5]])


def _to_second_order(coords, conn, edge_table):
    M = conn.shape[0]
    E = edge_table.shape[0]
    edges = conn[:, edge_table].reshape(-1, 2)           # [M*E, 2]
    new_coords, mid = _unique_edge_midpoints(coords, edges)
    mid = mid.reshape(M, E)
    return new_coords, np.concatenate([conn, mid], axis=1).astype(np.int32)


def tet4_to_tet10(coords, conn):
    """c3d4 -> c3d10 with edge nodes on edges 01, 12, 20, 03, 13, 23."""
    return _to_second_order(coords, conn, _TET_EDGES)


def hex8_to_hex20(coords, conn):
    """c3d8 -> c3d20 (VTK serendipity edge order)."""
    return _to_second_order(coords, conn, _HEX20_EDGES)


def wedge6_to_wedge15(coords, conn):
    """c3d6 -> c3d15 (VTK quadratic-wedge edge order)."""
    return _to_second_order(coords, conn, _WEDGE15_EDGES)


def box_tet10(nx, ny, nz, lx=1.0, ly=1.0, lz=1.0):
    return tet4_to_tet10(*box_tet(nx, ny, nz, lx, ly, lz))


def grid_quad(nx: int, ny: int, lx=1.0, ly=1.0, z=0.0):
    """Flat s4 shell grid in the plane at height z."""
    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), np.full(X.size, z)], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    conn = np.stack([nid(I, J), nid(I + 1, J), nid(I + 1, J + 1),
                     nid(I, J + 1)], axis=1)
    return coords, conn.astype(np.int32)


def grid_tri(nx: int, ny: int, lx=1.0, ly=1.0, z=0.0):
    """Flat s3 shell grid (each quad split into two triangles)."""
    coords, quads = grid_quad(nx, ny, lx, ly, z)
    t1 = quads[:, [0, 1, 2]]
    t2 = quads[:, [0, 2, 3]]
    return coords, np.concatenate([t1, t2], axis=0).astype(np.int32)


def boundary_nodes(coords, axis: int = 0, value: float = 0.0, tol=1e-9):
    """Node ids lying on a coordinate plane (for fixing faces)."""
    return np.nonzero(np.abs(coords[:, axis] - value) < tol)[0].astype(np.int32)
