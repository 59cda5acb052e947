"""Linear (c3d4) tetrahedra: a structured box of hexahedra, each split
into six positively oriented Kuhn tetrahedra (``portbench.mesh.box_tet``,
the arithmetic of the program's ``utils.meshgen.box_tet``)."""
from __future__ import annotations

from .. import mesh as meshmod


def make(n, size):
    return meshmod.box_tet(*n, *size)


def sizes(n) -> tuple:
    """(elements, nodes): six tetrahedra a cell, the cells' corners."""
    nx, ny, nz = n
    return 6 * nx * ny * nz, (nx + 1) * (ny + 1) * (nz + 1)
