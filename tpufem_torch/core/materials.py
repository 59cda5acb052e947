"""Isotropic 3D elasticity and the Kirchhoff shell stiffness (host numpy
copies of tpufem/core/materials.py).

Voigt convention: strain = [e_xx, e_yy, e_zz, g_xy, g_yz, g_zx] with
engineering shears; stress in the same order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def lame_parameters(E: float, nu: float) -> Tuple[float, float]:
    """(lambda, mu) from Young's modulus and Poisson ratio."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


def elasticity_matrix(E: float, nu: float, dtype=np.float64) -> np.ndarray:
    """Isotropic 6x6 Voigt D with stress = D @ strain (host numpy)."""
    lam, mu = lame_parameters(E, nu)
    D = np.zeros((6, 6), dtype=dtype)
    D[:3, :3] = lam
    D[0, 0] = D[1, 1] = D[2, 2] = lam + 2.0 * mu
    D[3, 3] = D[4, 4] = D[5, 5] = mu
    return D


def kirchhoff_D_matrix(membrane, bending, dtype=np.float64) -> np.ndarray:
    """Decoupled membrane + bending 6x6 shell stiffness (host numpy).

    membrane and bending are (E, nu, thickness) triples: membrane block
    a = E t / (1 - nu^2), bending block b = E t^3 / (12 (1 - nu^2))."""
    E_m, nu_m, t_m = (float(v) for v in membrane)
    E_b, nu_b, t_b = (float(v) for v in bending)
    a = E_m * t_m / (1.0 - nu_m**2)
    b = E_b * t_b**3 / (12.0 * (1.0 - nu_b**2))
    D = np.zeros((6, 6), dtype=dtype)
    D[0, 0] = D[1, 1] = a
    D[0, 1] = D[1, 0] = nu_m * a
    D[2, 2] = a * (1.0 - nu_m) / 2.0
    D[3, 3] = D[4, 4] = b
    D[3, 4] = D[4, 3] = nu_b * b
    D[5, 5] = b * (1.0 - nu_b) / 2.0
    return D
