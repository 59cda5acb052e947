"""Newton-Raphson outer loop for K(u) u = F with a CG inner solve (the port
of tpufem/solvers/newton.py).

The stiffness rebuild K(u) is an arbitrary user callable, so the outer loop
runs on the host, as tpufem's; each inner solve is solvers.cg.cg (its
blocks are CUDA graphs on the card).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .cg import cg, dot


class NewtonInfo(NamedTuple):
    iterations: int
    converged: bool
    residual_norms: np.ndarray  # [n_outer]


class _Increment:
    """Homogeneous constraints on the increment: the state is projected
    like a residual."""

    def __init__(self, constraints):
        self.constraints = constraints

    def project_residual(self, r):
        return self.constraints.project_residual(r)

    def apply_state(self, du):
        return self.constraints.project_residual(du)


def newton_raphson(K_operator_fn: Callable, F_ext: torch.Tensor, *,
                   constraints=None, u_init: Optional[torch.Tensor] = None,
                   tol: float = 1e-8, max_iter: int = 50,
                   inner_tol: float = 1e-8, inner_max_iter: int = 200):
    """Solve K(u) u = F_ext.

    K_operator_fn: u -> (a linear operator du -> K(u) du), e.g. a
    MatrixFreeOperator built from the element stiffness at u.  Returns
    (u, NewtonInfo)."""
    u = torch.zeros_like(F_ext) if u_init is None else u_init
    if constraints is not None:
        u = constraints.apply_state(u)
    inc = _Increment(constraints) if constraints is not None else None
    history = []
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        A = K_operator_fn(u)
        R = F_ext - A(u)
        if constraints is not None:
            R = constraints.project_residual(R)
        rnorm = float(torch.sqrt(dot(R, R)))
        history.append(rnorm)
        if rnorm < tol:
            converged = True
            break
        du, _ = cg(A, R, constraints=inc, tol=inner_tol,
                   max_iter=inner_max_iter)
        u = u + du
        if constraints is not None:
            u = constraints.apply_state(u)
    return u, NewtonInfo(it, converged, np.asarray(history))
