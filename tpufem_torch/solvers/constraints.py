"""Fixed-node constraints (the SPC subset of tpufem.solvers.constraints).

A fixed node pins all of its DOFs to zero.  On a device field [N, nd]
`apply_state` and `project_residual` multiply by the 0/1 free mask (the
SPC-only path of tpufem/solvers/constraints.py); ops.packed.
PackedConstraints turns the same mask into the packed layout.  SPC values,
RBE2 and RBE3 are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Flattened constraint tables over n_nodes * dof_per_node DOFs (host
    numpy)."""

    free_mask: np.ndarray      # [n_dof] 1.0 free / 0.0 constrained
    spc_dofs: np.ndarray       # [S] int32
    spc_values: np.ndarray     # [S]
    n_nodes: int
    dof_per_node: int
    # the mask as a [N, nd] tensor, per (device, dtype), made at first use
    _masks: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def mask2d(self) -> np.ndarray:
        return self.free_mask.reshape(self.n_nodes, self.dof_per_node)

    def mask_like(self, x: torch.Tensor) -> torch.Tensor:
        """The free mask [N, nd] on x's device, in x's dtype."""
        key = (x.device, x.dtype)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(self.mask2d, dtype=x.dtype,
                                               device=x.device)
        return self._masks[key]

    def apply_state(self, u: torch.Tensor) -> torch.Tensor:
        """Set the constrained values (zero) of a displacement-like field
        [N, nd]."""
        return u * self.mask_like(u)

    def project_residual(self, r: torch.Tensor) -> torch.Tensor:
        """Zero the constrained entries of a residual-like field [N, nd]."""
        return r * self.mask_like(r)

    @staticmethod
    def fixed(n_nodes: int, fixed_nodes, dof_per_node: int = 3,
              dtype=np.float64) -> "Constraints":
        """Homogeneous all-DOF pin of the given nodes."""
        nd = dof_per_node
        nodes = np.asarray(fixed_nodes if fixed_nodes is not None else [],
                           np.int64).reshape(-1)
        dofs = (nodes[:, None] * nd + np.arange(nd)).reshape(-1)
        mask = np.ones(n_nodes * nd, dtype=dtype)
        mask[dofs] = 0.0
        return Constraints(free_mask=mask, spc_dofs=dofs.astype(np.int32),
                           spc_values=np.zeros(dofs.size, dtype),
                           n_nodes=int(n_nodes), dof_per_node=nd)
