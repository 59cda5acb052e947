"""The benchmark's meshes: a configuration's mesh made by its generator
(``portbench/meshes/<generator>.py``, found by name), the structured boxes
that the generators share, and the plane selector that picks the nodes of
a face.

Structured hexahedral boxes split into six Kuhn tetrahedra each.  The
arithmetic is that of tpufem's ``utils.meshgen`` (``box_hex``,
``box_tet``, ``boundary_nodes``), copied here so that a later change to
the program cannot move the benchmark's inputs.  Host numpy only: nothing
here imports torch or the program.
"""
from __future__ import annotations

import importlib

import numpy as np


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


def boundary_nodes(coords, axis: int = 0, value: float = 0.0, tol=1e-9):
    """Ids of the nodes on the plane coords[:, axis] == value."""
    return np.nonzero(np.abs(coords[:, axis] - value) < tol)[0].astype(
        np.int32)


def generator(name: str):
    """The module ``portbench.meshes.<name>`` (see portbench.meshes)."""
    return importlib.import_module("portbench.meshes." + name)


def make(mesh: dict):
    """(coords, conn) of a configuration's "mesh" entry: its generator's
    ``make(n, size)``."""
    return generator(mesh["generator"]).make(mesh["n"], mesh["size"])
