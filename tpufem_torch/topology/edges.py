"""Edge extraction for solids and shells (host-side, setup time).

A copy of tpufem/topology/edges.py (jax-free), on the port's native module
and meshgen; outputs are bitwise tpufem's."""
from __future__ import annotations

import numpy as np

from ..utils.meshgen import unique_rows2

_EDGE_TABLES = {
    "c3d4": np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]),
    "c3d10": np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]),
    "c3d8": np.array([[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6],
                      [6, 7], [7, 4], [0, 4], [1, 5], [2, 6], [3, 7]]),
    "c3d20": np.array([[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6],
                       [6, 7], [7, 4], [0, 4], [1, 5], [2, 6], [3, 7]]),
    "c3d6": np.array([[0, 1], [1, 2], [2, 0], [3, 4], [4, 5], [5, 3],
                      [0, 3], [1, 4], [2, 5]]),
    "c3d15": np.array([[0, 1], [1, 2], [2, 0], [3, 4], [4, 5], [5, 3],
                       [0, 3], [1, 4], [2, 5]]),
    "s3": np.array([[0, 1], [1, 2], [2, 0]]),
    "s4": np.array([[0, 1], [1, 2], [2, 3], [3, 0]]),
}


def element_to_edge(conn, etype: str = "c3d4"):
    """Unique undirected node-edge list [2, E] (corner edges only).

    Parity: reference element_to_edge (solver/element.py:2687-2713).
    """
    from .. import native

    conn = np.asarray(conn)
    table = _EDGE_TABLES[etype.lower()]
    nat = native.unique_edges(conn, table)
    if nat is not None:
        order = np.lexsort((nat[:, 1], nat[:, 0]))
        return nat[order].T.copy()
    edges = conn[:, table].reshape(-1, 2)
    edges = np.sort(edges, axis=1)
    uniq, _ = unique_rows2(edges)
    return uniq.T.copy()


def _edge_incidence(conn, table):
    """(sorted edge keys [M*ne, 2], elem ids, edge ids)."""
    conn = np.asarray(conn)
    M = conn.shape[0]
    ne = table.shape[0]
    edges = np.sort(conn[:, table].reshape(-1, 2), axis=1)
    return edges, np.repeat(np.arange(M), ne), np.tile(np.arange(ne), M)


def shared_edges(conn, etype: str):
    """[S, 2, 2] pairs [[shell, edge_idx], [shell, edge_idx]] for edges
    shared by exactly two shells.

    Parity: identify_s3_shared_edges / identify_s4_shared_edges
    (solver/shell.py:205-259, 504-559).
    """
    table = _EDGE_TABLES[etype.lower()]
    edges, elem_ids, edge_ids = _edge_incidence(conn, table)
    base = int(edges.max()) + 1 if edges.size else 1
    key = edges[:, 0].astype(np.int64) * base + edges[:, 1]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    shared = np.nonzero(counts == 2)[0]
    if shared.size == 0:
        return np.empty((0, 2, 2), dtype=np.int64)
    order = np.argsort(inv, kind="stable")
    inv_s, el_s, ed_s = inv[order], elem_ids[order], edge_ids[order]
    pos = np.searchsorted(inv_s, shared)
    return np.stack([
        np.stack([el_s[pos], ed_s[pos]], axis=1),
        np.stack([el_s[pos + 1], ed_s[pos + 1]], axis=1),
    ], axis=1)


def boundary_edges(conn, etype: str):
    """Shell boundary edges + the opposite node of the owning shell.

    Returns (edges [K, 2], opposite_node [K]).  Parity:
    compute_triangle_surface_faces_with_third_node (solver/shell.py:261-295)
    and compute_square_surface_faces_with_fourth_node (:561-597).
    """
    et = etype.lower()
    conn = np.asarray(conn)
    table = _EDGE_TABLES[et]
    if et == "s3":
        opp_local = np.array([2, 0, 1])
    elif et == "s4":
        opp_local = np.array([3, 0, 1, 2])
    else:
        raise ValueError("boundary_edges is a shell operation (s3/s4)")
    edges_raw = conn[:, table].reshape(-1, 2)
    opp = conn[:, opp_local].reshape(-1)
    ek = np.sort(edges_raw, axis=1)
    base = int(ek.max()) + 1 if ek.size else 1
    key = ek[:, 0].astype(np.int64) * base + ek[:, 1]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    mask = counts[inv] == 1
    return edges_raw[mask], opp[mask]
