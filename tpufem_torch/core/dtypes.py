"""Precision policy, in torch's terms (the port of tpufem/core/dtypes.py).

tpufem bundles three dtypes that it threads through kernels and solvers:

* ``storage``: element stiffness, mass and coordinates (default f32);
* ``solve``: the Krylov vectors (default f32; f64 in validation runs);
* ``scalar``: the dot-product accumulators and CG recurrences.

On the TPU float64 is emulated and has to be switched on (jax_enable_x64);
on the H100 it is native, and a torch tensor carries its own dtype, so
``enable_x64`` sets torch's default floating dtype to float64 (the
analogue of tpufem's switch for code that makes tensors without a dtype)
and ``default_precision`` follows that default.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Bundle of dtypes threaded through kernels and solvers."""

    storage: Any = torch.float32
    solve: Any = torch.float32
    scalar: Any = torch.float32

    @staticmethod
    def tpu_default() -> "Precision":
        """f32 everywhere: tpufem's chip policy, the port's default."""
        return Precision(torch.float32, torch.float32, torch.float32)

    @staticmethod
    def highest() -> "Precision":
        """f64 everywhere (validation runs)."""
        return Precision(torch.float64, torch.float64, torch.float64)


def enable_x64() -> None:
    """Make float64 torch's default floating dtype."""
    torch.set_default_dtype(torch.float64)


def default_precision() -> Precision:
    """f64 when float64 is torch's default floating dtype, else f32."""
    if torch.get_default_dtype() == torch.float64:
        return Precision.highest()
    return Precision.tpu_default()
