"""String-keyed dispatch wrappers with the reference's names (the port of
tpufem/elements/dispatch.py): integral_points, compute_jacobian,
compute_shape_gradients, compute_B_matrix, compute_K_matrix,
compute_volumes, compute_M_matrix, compute_element_stress, and to_c3d4 /
to_2nd_order re-exported from topology.convert.

Thin conveniences over elements.solid: each takes host arrays or tensors,
moves them to `device` (None: the CUDA card) and returns tensors there.
Performance-sensitive code calls elements.solid with a prebuilt table.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..topology.convert import to_2nd_order, to_c3d4  # noqa: F401 (re-export)
from . import solid
from .tables import SHELL_TYPES, element_table, quadrature


def _on(coords, elements, device):
    """(coords, conn) as tensors on the resolved device."""
    dev = resolve_device(device)
    c = torch.as_tensor(coords if isinstance(coords, torch.Tensor)
                        else np.asarray(coords), device=dev)
    e = torch.as_tensor(elements if isinstance(elements, torch.Tensor)
                        else np.asarray(elements), device=dev).long()
    return c, e


def integral_points(element_type: str, rule: str = "default"):
    """(points [q, dim], weights [q]) as host numpy."""
    return quadrature(element_type, rule)


def compute_jacobian(coords, elements, element_type: str,
                     rule: str = "default", device=None) -> torch.Tensor:
    """J [M, q, 3, 3] at every integration point of the rule."""
    c, e = _on(coords, elements, device)
    return solid.jacobians(c, e, element_table(element_type, rule))


def compute_shape_gradients(coords, elements, element_type: str,
                            rule: str = "default", device=None):
    """(dN/dx [M, q, k, 3], detJ [M, q])."""
    c, e = _on(coords, elements, device)
    return solid.shape_gradients(c, e, element_table(element_type, rule))


def compute_B_matrix(coords, elements, element_type: str,
                     rule: str = "default", device=None) -> torch.Tensor:
    """B [M, q, 6, k, 3] strain-displacement matrices."""
    c, e = _on(coords, elements, device)
    g, _ = solid.shape_gradients(c, e, element_table(element_type, rule))
    return solid.b_matrix_from_gradients(g)


def compute_K_matrix(coords, elements, element_type: str, E: float,
                     nu: float, rule: str = "default",
                     D: Optional[np.ndarray] = None, single: bool = True,
                     device=None) -> torch.Tensor:
    """Element stiffness: single=True -> [M, dof, dof]; single=False ->
    per integration point [q, M, dof, dof]; D: a custom 6x6 material."""
    et = element_type.lower()
    if et in SHELL_TYPES:
        raise ValueError("use elements.shell.shell_stiffness for shells")
    c, e = _on(coords, elements, device)
    if not single:
        return solid.stiffness_per_ip(c, e, et, E, nu, rule)
    if D is not None:
        return solid.stiffness_bmat(c, e, et, D, rule)
    return solid.stiffness(c, e, et, E, nu, rule)


def compute_volumes(coords, elements, element_type: str,
                    device=None) -> torch.Tensor:
    """Element volumes [M]."""
    c, e = _on(coords, elements, device)
    return solid.volumes(c, e, etype=element_type)


def compute_M_matrix(coords, elements, element_type: str, rho: float,
                     lumped: bool = False, rule: str = "mass",
                     device=None) -> torch.Tensor:
    """Element mass: consistent [M, dof, dof] or lumped [M, dof]."""
    c, e = _on(coords, elements, device)
    if lumped:
        return solid.lumped_mass(c, e, element_type, rho, rule)
    return solid.mass(c, e, element_type, rho, rule)


def compute_element_stress(coords, elements, displacement, E: float,
                           nu: float, element_type: str,
                           rule: str = "default", single: bool = True,
                           device=None):
    """(stress tensors, von Mises) per element (single=True) or per
    integration point."""
    c, e = _on(coords, elements, device)
    u = torch.as_tensor(displacement if isinstance(displacement, torch.Tensor)
                        else np.asarray(displacement), device=c.device)
    return solid.element_stress(c, e, u, element_type, E, nu, rule,
                                single=single)
