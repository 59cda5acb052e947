"""Mesh topology: boundary faces, outward normals, shared faces, curvature.

A copy of tpufem/topology/faces.py (jax-free), on the port's native
module; outputs are bitwise tpufem's.

Host-side numpy, run once at setup time (data-dependent output sizes cannot
live under jit — SURVEY.md "hard parts" #5).  All functions follow the
reference idiom: enumerate candidate faces per element -> sort node ids ->
unique with counts -> count==1 boundary / count==2 shared
(solver/element.py:543-762, 1293-1532, 2234-2338).

Canonical per-type face tables (face index -> local nodes, opposite node):

* tet   (solver/element.py:652-705): (0,1,2|3), (0,1,3|2), (1,2,3|0), (0,2,3|1)
* hex   (solver/element.py:1418-1472): (0,1,5,4|2), (1,2,6,5|0), (2,3,7,6|0),
        (0,4,7,3|1), (0,3,2,1|6), (4,5,6,7|0)
* wedge (solver/element.py:2234-2283): quads (0,1,4,3|2), (1,2,5,4|0),
        (2,0,3,5|1); tris (0,2,1|3), (3,4,5|0)

Second-order types reuse their corner sub-connectivity.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

TET_FACES = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 3], [0, 2, 3]])
TET_OPPOSITE = np.array([3, 2, 0, 1])

HEX_FACES = np.array([
    [0, 1, 5, 4], [1, 2, 6, 5], [2, 3, 7, 6],
    [0, 4, 7, 3], [0, 3, 2, 1], [4, 5, 6, 7],
])
HEX_OPPOSITE = np.array([2, 0, 0, 1, 6, 0])

WEDGE_QUAD_FACES = np.array([[0, 1, 4, 3], [1, 2, 5, 4], [2, 0, 3, 5]])
WEDGE_QUAD_OPPOSITE = np.array([2, 0, 1])
WEDGE_TRI_FACES = np.array([[0, 2, 1], [3, 4, 5]])
WEDGE_TRI_OPPOSITE = np.array([3, 0])


def _corner_family(etype: str) -> str:
    et = etype.lower()
    if et in ("c3d4", "c3d10"):
        return "tet"
    if et in ("c3d8", "c3d20"):
        return "hex"
    if et in ("c3d6", "c3d15"):
        return "wedge"
    raise ValueError(f"Unsupported solid element type: {etype}")


def _face_tables(etype: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    fam = _corner_family(etype)
    if fam == "tet":
        return [(TET_FACES, TET_OPPOSITE)]
    if fam == "hex":
        return [(HEX_FACES, HEX_OPPOSITE)]
    return [(WEDGE_QUAD_FACES, WEDGE_QUAD_OPPOSITE),
            (WEDGE_TRI_FACES, WEDGE_TRI_OPPOSITE)]


def _boundary_mask(faces_flat: np.ndarray):
    key = np.sort(faces_flat, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    return counts[inv] == 1


def boundary_faces(conn, etype: str):
    """Boundary faces + the opposite ('fourth') node used to orient normals.

    Returns a dict {face_kind: (faces [K,fk], opposite_node [K])} with kinds
    "tri"/"quad".  Parity: compute_tetrahedral_surface_faces_with_fourth_node
    (solver/element.py:543), hex :1293, wedge :2234.  Uses the native hash
    extractor when available (same element-major emission order).
    """
    from .. import native

    conn = np.asarray(conn)
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for table, opp in _face_tables(etype):
        kind = "tri" if table.shape[1] == 3 else "quad"
        nat = native.extract_faces(conn, table, opp)
        if nat is not None:
            out[kind] = (nat[0], nat[1])
            continue
        faces = conn[:, table].reshape(-1, table.shape[1])
        opposite = conn[:, opp].reshape(-1)
        mask = _boundary_mask(faces)
        out[kind] = (faces[mask], opposite[mask])
    return out


def outward_surface_normals(coords, conn, etype: str, unit: bool = True):
    """Outward unit normals of the boundary faces.

    Returns {face_kind: (faces, normals [K,3])}.  Orientation by the
    opposite-node dot test, as solver/element.py:581-619.
    """
    coords = np.asarray(coords)
    result = {}
    for kind, (faces, opposite) in boundary_faces(conn, etype).items():
        p = coords[faces]                                  # [K,fk,3]
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        if unit:
            n = n / np.linalg.norm(n, axis=1, keepdims=True)
        centers = p.mean(axis=1)
        to_opp = coords[opposite] - centers
        flip = np.einsum("kd,kd->k", n, to_opp) > 0
        n[flip] = -n[flip]
        result[kind] = (faces, n)
    return result


def face_normals_area(coords, conn, etype: str):
    """Per-element outward face normals scaled by area.

    Returns {face_kind: normals [M, n_faces_of_kind, 3]}; triangle normals
    have magnitude = area (cross/2, solver/element.py:652-705), quads use the
    bilinear cross of the two edge midlines (exact for planar quads,
    solver/element.py:1418-1472 uses edge1 x edge2 without the 1/2).
    """
    coords = np.asarray(coords)
    conn = np.asarray(conn)
    out = {}
    for table, opp in _face_tables(etype):
        fc = coords[conn[:, table]]                       # [M,f,fk,3]
        if table.shape[1] == 3:
            n = 0.5 * np.cross(fc[:, :, 1] - fc[:, :, 0], fc[:, :, 2] - fc[:, :, 0])
        else:
            # area vector of a (possibly non-planar) quad: 1/2 d1 x d2
            d1 = fc[:, :, 2] - fc[:, :, 0]
            d2 = fc[:, :, 3] - fc[:, :, 1]
            n = 0.5 * np.cross(d1, d2)
        centers = fc.mean(axis=2)
        to_opp = coords[conn[:, opp]] - centers
        flip = np.einsum("mfd,mfd->mf", n, to_opp) > 0
        n[flip] = -n[flip]
        kind = "tri" if table.shape[1] == 3 else "quad"
        out[kind] = n
    return out


def shared_faces(conn, etype: str):
    """[S, 2, 2] interior-face connectivity: [[elem, face_idx], [elem, face_idx]].

    Face indices count quad faces first for wedges (matching the canonical
    table order above).  Parity: identify_tetrahedral_shared_faces
    (solver/element.py:707-762) and hex variant :1474-1532.
    """
    from .. import native

    conn = np.asarray(conn)
    M = conn.shape[0]
    tables = _face_tables(etype)
    if len(tables) == 1:
        nat = native.extract_faces(conn, tables[0][0], tables[0][1])
        if nat is not None:
            return _canonical_shared_order(nat[2])
    else:
        nats = [native.extract_faces(conn, t, o) for t, o in tables]
        if all(n is not None for n in nats):
            parts, base = [], 0
            for (t, _), n in zip(tables, nats):
                sf = n[2].copy()
                sf[:, :, 1] += base
                parts.append(sf)
                base += t.shape[0]
            return _canonical_shared_order(np.concatenate(parts, axis=0))
    all_keys, elem_ids, face_ids = [], [], []
    base = 0
    for table, _ in tables:
        nf, fk = table.shape
        faces = conn[:, table]                             # [M,nf,fk]
        key = np.sort(faces.reshape(-1, fk), axis=1)
        # pad tri keys to width 4 with -1 so tri/quad never collide
        if fk == 3:
            key = np.concatenate([np.full((key.shape[0], 1), -1, key.dtype), key], axis=1)
        all_keys.append(key)
        elem_ids.append(np.repeat(np.arange(M), nf))
        face_ids.append(np.tile(np.arange(nf) + base, M))
        base += nf
    keys = np.concatenate(all_keys)
    elem_ids = np.concatenate(elem_ids)
    face_ids = np.concatenate(face_ids)

    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    shared_ids = np.nonzero(counts == 2)[0]
    if shared_ids.size == 0:
        return np.empty((0, 2, 2), dtype=np.int64)
    order = np.argsort(inv, kind="stable")
    inv_s, elem_s, face_s = inv[order], elem_ids[order], face_ids[order]
    pos = np.searchsorted(inv_s, shared_ids)
    pair = np.stack([
        np.stack([elem_s[pos], face_s[pos]], axis=1),
        np.stack([elem_s[pos + 1], face_s[pos + 1]], axis=1),
    ], axis=1)
    return _canonical_shared_order(pair)


def _canonical_shared_order(pair: np.ndarray) -> np.ndarray:
    """Sort shared-face pairs by (elem1, face1) so the native and numpy
    extraction paths produce identical arrays."""
    if pair.shape[0] == 0:
        return pair
    order = np.lexsort((pair[:, 0, 1], pair[:, 0, 0]))
    return pair[order]


def node_curvatures(coords, conn, etype: str):
    """Mean of adjacent boundary-face unit normals per node, [N, 3].

    The reference's implementations of this are all broken (undefined
    variables / wrong signatures, solver/element.py:621-650, 1376-1416,
    2340-2375 — SURVEY.md 2.7); this is the evident intent, working.
    """
    coords = np.asarray(coords)
    N = coords.shape[0]
    acc = np.zeros((N, 3))
    cnt = np.zeros(N)
    for kind, (faces, normals) in outward_surface_normals(coords, conn, etype).items():
        fk = faces.shape[1]
        np.add.at(acc, faces.reshape(-1), np.repeat(normals, fk, axis=0))
        np.add.at(cnt, faces.reshape(-1), 1.0)
    cnt[cnt == 0] = 1.0
    return acc / cnt[:, None]


def element_dual_graph(conn, etype: str):
    """[2, E] element-adjacency edge list (elements sharing a face).

    This is the graph the subdivision partitioner grows regions on
    (subdivision.ipynb cells 8-9).
    """
    sf = shared_faces(conn, etype)
    return sf[:, :, 0].T.copy()
