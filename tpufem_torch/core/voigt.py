"""Voigt vector <-> tensor conversion and the von Mises invariant (torch,
batched); the port of tpufem/core/voigt.py.

Layout: index 3 -> (0,1)=xy, index 4 -> (1,2)=yz, index 5 -> (0,2)=zx.
"""
from __future__ import annotations

import torch


def stress_tensor(stress_vector: torch.Tensor) -> torch.Tensor:
    """[..., 6] Voigt -> [..., 3, 3] symmetric tensor."""
    s = stress_vector
    row0 = torch.stack([s[..., 0], s[..., 3], s[..., 5]], dim=-1)
    row1 = torch.stack([s[..., 3], s[..., 1], s[..., 4]], dim=-1)
    row2 = torch.stack([s[..., 5], s[..., 4], s[..., 2]], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def stress_vector(stress_tensor: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric tensor -> [..., 6] Voigt (xx, yy, zz, xy, yz,
    xz)."""
    t = stress_tensor
    return torch.stack([t[..., 0, 0], t[..., 1, 1], t[..., 2, 2],
                        t[..., 0, 1], t[..., 1, 2], t[..., 0, 2]], dim=-1)


def von_mises(stress: torch.Tensor) -> torch.Tensor:
    """Von Mises invariant from a [..., 3, 3] tensor or a [..., 6] Voigt
    vector."""
    if stress.shape[-1] == 6 and (stress.dim() == 1
                                  or stress.shape[-2] != 3):
        sxx, syy, szz = stress[..., 0], stress[..., 1], stress[..., 2]
        sxy, syz, szx = stress[..., 3], stress[..., 4], stress[..., 5]
    else:
        sxx, syy, szz = stress[..., 0, 0], stress[..., 1, 1], stress[..., 2, 2]
        sxy, syz, szx = stress[..., 0, 1], stress[..., 1, 2], stress[..., 0, 2]
    return torch.sqrt(
        0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
        + 3.0 * (sxy ** 2 + syz ** 2 + szx ** 2))
