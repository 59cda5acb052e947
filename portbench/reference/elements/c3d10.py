"""Quadratic tetrahedra: the corner functions L (2L - 1) and the edge
functions 4 L_a L_b on edges 01, 12, 20, 03, 13, 23, L0 = 1 - xi - eta -
zeta, and the four-point degree-2 rule on the reference tetrahedron
(weights 1/24)."""
import numpy as np

_A, _B = 0.5854101966249685, 0.13819660112501052
POINTS = np.array([[_A, _B, _B], [_B, _A, _B], [_B, _B, _A], [_B, _B, _B]])
WEIGHTS = np.full(4, 1.0 / 24.0)
EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))


def gradients(points: np.ndarray) -> np.ndarray:
    """[q, 10, 3] derivatives of the c3d10 shape functions in (xi, eta,
    zeta) at `points` [q, 3]."""
    xi, eta, zeta = points[:, 0], points[:, 1], points[:, 2]
    L = np.stack([1 - xi - eta - zeta, xi, eta, zeta], axis=1)
    dL = np.array([[-1., -1., -1.], [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]])
    dN = np.zeros((points.shape[0], 10, 3))
    for i in range(4):
        dN[:, i] = (4 * L[:, i:i + 1] - 1) * dL[i]
    for m, (a, b) in enumerate(EDGES):
        dN[:, 4 + m] = 4 * (L[:, a:a + 1] * dL[b] + L[:, b:b + 1] * dL[a])
    return dN
