"""Linear tetrahedra: the barycentric functions L0 = 1 - xi - eta - zeta,
L1 = xi, L2 = eta, L3 = zeta, whose gradients are constant, and one point
at the centroid with the reference tetrahedron's volume 1/6 as its weight:
exact for the constant strain of a linear tetrahedron."""
import numpy as np

POINTS = np.array([[0.25, 0.25, 0.25]])
WEIGHTS = np.array([1.0 / 6.0])


def gradients(points: np.ndarray) -> np.ndarray:
    """[q, 4, 3] derivatives of the c3d4 shape functions in (xi, eta,
    zeta), the same at every point of `points` [q, 3]."""
    dL = np.array([[-1., -1., -1.], [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]])
    return np.broadcast_to(dL, (points.shape[0], 4, 3)).copy()
