"""Matrix-free global operator: the assembled-stiffness SpMV.

The port of tpufem/ops/operator.py.  A(u) = gather element DOFs -> batched
GEMV with the per-element K -> deterministic classed-bin scatter
(ops.scatter).  tpufem runs all three in XLA, outside any kernel; here the
GEMV is one batched torch matmul (full float32 with TF32 off) and the
gather and scatter are torch indexing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .scatter import ScatterPlan


def element_gemv(K: torch.Tensor, ue: torch.Tensor) -> torch.Tensor:
    """Fe[..., i] = sum_j K[..., i, j] ue[..., j] (batched matmul)."""
    return torch.matmul(K, ue.unsqueeze(-1)).squeeze(-1)


def nodal_forces(K: torch.Tensor, conn_or_plan, displacement: torch.Tensor,
                 n_nodes: Optional[int] = None) -> torch.Tensor:
    """Global nodal forces F[N, 3] = assemble(K_e @ u_e).

    conn_or_plan: a prebuilt ScatterPlan, or connectivity [M, k] (a plan
    is then built on the fly, on displacement's device)."""
    if isinstance(conn_or_plan, ScatterPlan):
        plan = conn_or_plan
    else:
        n = int(displacement.shape[0]) if n_nodes is None else n_nodes
        conn = conn_or_plan
        if isinstance(conn, torch.Tensor):
            conn = conn.cpu().numpy()
        plan = ScatterPlan.build(conn, n, 3, device=displacement.device)
    ue = plan.gather(displacement.reshape(-1))               # [M, d]
    return plan.scatter(element_gemv(K, ue)).reshape(displacement.shape)


class MatrixFreeOperator(torch.nn.Module):
    """u[N, 3] -> F[N, 3] for one element block; composable by summation.

    K [M, d, d] is a buffer on the plan's device (a numpy K, such as
    tpufem's, is copied there)."""

    def __init__(self, K, plan: ScatterPlan):
        super().__init__()
        if not isinstance(K, torch.Tensor):
            K = torch.tensor(np.asarray(K))
        self.register_buffer("K", K.to(plan.device))
        self.plan = plan

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return nodal_forces(self.K, self.plan, u)

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal of the global matrix, [n_dof]."""
        d = torch.diagonal(self.K, dim1=1, dim2=2)          # [M, d]
        return self.plan.scatter(d.contiguous())


def block_operator(ops: Sequence[torch.nn.Module]):
    """Sum of per-element-type operators (mixed meshes)."""
    def apply(u):
        F = ops[0](u)
        for op in ops[1:]:
            F = F + op(u)
        return F
    return apply


def diagonal_preconditioner(ops: Sequence[torch.nn.Module],
                            eps: float = 0.0) -> torch.Tensor:
    """Inverse assembled diagonal (Jacobi M^-1), shape [N, 3]; DOFs whose
    diagonal is not above eps map to 0 instead of inf."""
    diag = ops[0].diagonal()
    for op in ops[1:]:
        diag = diag + op.diagonal()
    inv = torch.where(diag.abs() > eps, 1.0 / diag, 0.0)
    return inv.reshape(-1, 3)
