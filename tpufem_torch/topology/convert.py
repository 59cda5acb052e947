"""Element order/type conversion (host-side numpy, setup time; a copy of
tpufem/topology/convert.py, which imports no JAX).

Covers the reference's decomposition tables (solver/element.py:963-993,
1555-1581, 1852-1896, 2424-2446), the c3d4 -> c3d10 promotion with
constraint-set propagation (solver/element.py:777-833, vectorized here —
the reference's version is a pure-Python dict loop that also references an
undefined variable), and shell -> solid extrusion (solver/shell.py:885-983).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.meshgen import (_unique_edge_midpoints, unique_rows2, _TET_EDGES,
                             hex8_to_hex20, tet4_to_tet10, wedge6_to_wedge15)

# Sub-tetrahedra tables (reference solver/element.py):
C3D10_TO_C3D4 = np.array([
    [0, 4, 6, 7], [4, 1, 5, 8], [6, 5, 2, 9], [7, 8, 9, 3],
    [4, 6, 7, 5], [6, 7, 9, 5], [4, 7, 8, 5], [5, 8, 7, 9],
])  # :977-986
C3D8_TO_C3D4 = np.array([
    [0, 1, 3, 4], [1, 2, 3, 6], [1, 3, 4, 5],
    [3, 4, 5, 7], [3, 5, 6, 7], [3, 5, 6, 2],
])  # :1567-1574
C3D20_TO_C3D4 = np.array([
    [0, 8, 12, 19], [8, 1, 13, 9], [9, 1, 2, 10], [10, 2, 14, 11],
    [11, 2, 3, 15], [15, 3, 19, 0], [12, 4, 16, 19], [16, 4, 5, 17],
    [17, 5, 13, 18], [18, 5, 6, 14], [14, 6, 18, 7], [19, 7, 15, 11],
    [8, 9, 10, 11], [8, 10, 11, 12], [12, 13, 14, 15], [16, 17, 18, 19],
    [0, 8, 9, 10], [0, 10, 11, 12], [1, 9, 10, 13], [1, 13, 14, 17],
    [2, 10, 14, 15], [3, 11, 15, 19], [4, 12, 16, 19], [5, 13, 17, 18],
])  # :1864-1889 (the reference's own table; kept for behavioral parity)
C3D6_TO_C3D4 = np.array([
    [0, 1, 2, 3], [1, 2, 3, 5], [1, 3, 4, 5],
])  # :2435-2439


def to_c3d4(conn, etype: Optional[str] = None) -> np.ndarray:
    """Decompose any higher-order/solid type into covering c3d4 elements.

    Dispatch parity with reference to_c3d4 (solver/element.py:355-364).
    """
    conn = np.asarray(conn)
    n = conn.shape[1] if etype is None else None
    et = (etype or {6: "c3d6", 8: "c3d8", 10: "c3d10", 20: "c3d20"}[n]).lower()
    table = {"c3d6": C3D6_TO_C3D4, "c3d8": C3D8_TO_C3D4,
             "c3d10": C3D10_TO_C3D4, "c3d20": C3D20_TO_C3D4}[et]
    return conn[:, table].reshape(-1, 4).astype(np.int32)


def c3d4_to_c3d10(coords, conn, rbe2_ids=None, rbe3_ids=None):
    """Promote c3d4 -> c3d10 by unique edge-midpoint insertion.

    A midpoint joins a constraint set when both edge endpoints belong to it
    (same propagation rule as the reference, solver/element.py:817-820).

    Returns (new_coords, new_conn [M,10], rbe2_new, rbe3_new).
    """
    coords = np.asarray(coords)
    conn = np.asarray(conn)
    edges = conn[:, _TET_EDGES].reshape(-1, 2)
    new_coords, mid = _unique_edge_midpoints(coords, edges)
    mid = mid.reshape(conn.shape[0], 6)
    new_conn = np.concatenate([conn, mid], axis=1).astype(np.int32)

    def _propagate(ids):
        if ids is None:
            return None
        ids = np.asarray(ids).reshape(-1)
        member = np.zeros(coords.shape[0], bool)
        member[ids] = True
        e_sorted = np.sort(edges, axis=1)
        uniq_edges, _ = unique_rows2(e_sorted, coords.shape[0])
        both = member[uniq_edges[:, 0]] & member[uniq_edges[:, 1]]
        new_ids = coords.shape[0] + np.nonzero(both)[0]
        return np.concatenate([ids, new_ids]).astype(np.int32)

    return new_coords, new_conn, _propagate(rbe2_ids), _propagate(rbe3_ids)


def to_2nd_order(coords, conn, etype: str = "c3d4", rbe2=None, rbe3=None):
    """Dispatch parity with reference to_2nd_order (solver/element.py:366)."""
    et = etype.lower()
    if et == "c3d4":
        return c3d4_to_c3d10(coords, conn, rbe2, rbe3)
    if et == "c3d8":
        return hex8_to_hex20(coords, conn) + (rbe2, rbe3)
    if et == "c3d6":
        return wedge6_to_wedge15(coords, conn) + (rbe2, rbe3)
    raise ValueError(f"to_2nd_order: unsupported type {etype}")


def shell_extrude(coords, tri=None, quad=None, thickness: float = 1.0,
                  eps: float = 1e-8) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extrude a mid-surface shell mesh into c3d6 wedges + c3d8 hexes.

    Per-node unit normals (area-weighted average of adjacent facet normals)
    -> offset +-t/2 -> bottom nodes [0..N) and top nodes [N..2N).
    Parity: reference shell_extrude (solver/shell.py:885-983).

    Returns (coords_3d [2N,3], wedges [T,6], hexes [S,8]).
    """
    coords = np.asarray(coords, dtype=np.float64)
    N = coords.shape[0]
    tri = np.zeros((0, 3), np.int32) if tri is None else np.asarray(tri)
    quad = np.zeros((0, 4), np.int32) if quad is None else np.asarray(quad)

    normals = np.zeros((N, 3))
    counts = np.zeros(N)

    def _accumulate(face_tris):
        if face_tris.shape[0] == 0:
            return
        p = coords[face_tris]
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        n = n / (np.linalg.norm(n, axis=1, keepdims=True) + eps)
        np.add.at(normals, face_tris.reshape(-1), np.repeat(n, 3, axis=0))
        np.add.at(counts, face_tris.reshape(-1), 1.0)

    _accumulate(tri)
    _accumulate(quad[:, [0, 1, 2]])
    _accumulate(quad[:, [0, 2, 3]])
    normals = normals / (counts[:, None] + eps)
    normals = normals / (np.linalg.norm(normals, axis=1, keepdims=True) + eps)

    bottom = coords - 0.5 * thickness * normals
    top = coords + 0.5 * thickness * normals
    coords_3d = np.concatenate([bottom, top], axis=0)
    wedges = np.concatenate([tri, tri + N], axis=1).astype(np.int32) if tri.size else np.zeros((0, 6), np.int32)
    hexes = np.concatenate([quad, quad + N], axis=1).astype(np.int32) if quad.size else np.zeros((0, 8), np.int32)
    return coords_3d, wedges, hexes
