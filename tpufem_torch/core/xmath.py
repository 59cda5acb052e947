"""Exact-precision contraction helper (the port of tpufem/core/xmath.py).

tpufem routes every accuracy-bearing einsum through ``xmath.einsum`` to set
``Precision.HIGHEST``: the TPU's default f32 contraction runs in bf16
passes.  On the H100 the analogue is TF32, which ``import tpufem_torch``
turns off (``torch.backends.cuda.matmul.allow_tf32 = False``), so a float32
``torch.einsum`` is already exact to f32 and this is that einsum.
"""
from __future__ import annotations

import torch


def einsum(*args, **kwargs) -> torch.Tensor:
    """torch.einsum under the port's TF32-off policy; tpufem's
    ``precision=`` keyword is accepted and has no other meaning here."""
    kwargs.pop("precision", None)
    return torch.einsum(*args, **kwargs)
