"""Quadratic (c3d10) tetrahedra: the Kuhn box of ``box_tet4`` promoted by
one node at the middle of every edge (the arithmetic of the program's
``utils.meshgen.box_tet10`` and ``tet4_to_tet10``).  The unique edge list
is ``np.unique`` on one int64 key per edge, which orders edges as the
program's radix sort does."""
from __future__ import annotations

import numpy as np

from .. import mesh as meshmod

_TET_EDGES = np.array([[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]])


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


def make(n, size):
    return tet4_to_tet10(*meshmod.box_tet(*n, *size))


def sizes(n) -> tuple:
    """(elements, nodes), from the counts alone: every point of the
    half-step lattice is a corner or the middle of an edge."""
    nx, ny, nz = n
    return 6 * nx * ny * nz, (2 * nx + 1) * (2 * ny + 1) * (2 * nz + 1)
