"""Force-balance equilibrium diagnostics (a copy of
tpufem/topology/diagnostics.py, which is jax-free).

Parity: compute_c3d4_surface_forces (solver/element.py:3343-3360) and
compute_c3d4_shared_face_forces_sum (:3362-3383) — traction force
sigma . (n * A) per element face, and the interior-face action/reaction sum
which must vanish at equilibrium (for constant-stress elements).
Generalized to any solid family via the canonical face tables.
"""
from __future__ import annotations

import numpy as np

from .faces import face_normals_area, shared_faces


def surface_forces(normal_vectors, stress_tensors):
    """Face traction forces [M, n_faces, 3] = sigma_m @ (n*A)_mf."""
    return np.einsum("mab,mfb->mfa", np.asarray(stress_tensors),
                     np.asarray(normal_vectors))


def element_face_forces(coords, conn, etype: str, stress_tensors):
    """All per-element face forces, quad faces first (canonical order)."""
    na = face_normals_area(coords, conn, etype)
    parts = []
    if "quad" in na:
        parts.append(surface_forces(na["quad"], stress_tensors))
    if "tri" in na:
        parts.append(surface_forces(na["tri"], stress_tensors))
    return np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]


def shared_face_force_residual(conn, etype: str, face_forces):
    """[S, 3] sum of the two tractions on every interior face (~0 at
    equilibrium for piecewise-constant stress)."""
    sf = shared_faces(conn, etype)
    f1 = face_forces[sf[:, 0, 0], sf[:, 0, 1]]
    f2 = face_forces[sf[:, 1, 0], sf[:, 1, 1]]
    return f1 + f2
