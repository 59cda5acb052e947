"""The float64 packed Jacobi PCG: ``PackedSystem.solve`` in float64.

The packed operator (kernels fused_yc and combine in every apply), the
plan and the PCG blocks of the refined path, all in float64, the fixed
nodes pinned, scalar Jacobi.  Each case is solved with its load scaled to
unit norm, so that one PCG block (one set of CUDA graphs, captured at
set-up) serves every case at the traffic's relative tolerance, and the
answer is scaled back.

The control is the same path with the operator and the PCG in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import packed_apply_call, packed_diagonal

OPERATOR = "packed"
DTYPE = "float64"
# largest relative difference of the float64 diagonal from the reference's
# (PERF.md gives the readings it was set from)
DIAG_LIMIT = 1e-9
# the warm solve's cap: two of the PCG's 32-iteration graph blocks
WARM_ITERATIONS = 64


class Path:
    def __init__(self, mesh, config, traffic, device, stages, control=False):
        import tpufem_torch as tt

        E, nu = config["material"]["E"], config["material"]["nu"]
        etype = config["element"]["type"]
        dtype = torch.float32 if control else torch.float64
        self.tol = float(traffic["tol_rel"])
        self.max_iter = int(traffic["max_iter"])
        N = mesh.coords.shape[0]
        self.device = device
        with stages("plan"):
            plan = tt.PackedPlan.build(mesh.coords, mesh.conn, N,
                                       device=device)
        with stages("operator"):
            op = tt.PackedPartialOperator.build(
                mesh.coords, mesh.conn, etype, E, nu, plan=plan,
                dtype=dtype, device=device)
        with stages("system"):
            self.system = tt.PackedSystem(op, fixed_nodes=mesh.fixed,
                                          precondition="jacobi")
        with stages("capture"):
            self.system.warm(tol=self.tol, max_iter=self.max_iter)

    def solve(self, b: np.ndarray):
        return self._solve(b, self.max_iter)

    def warm(self, b: np.ndarray) -> None:
        self._solve(b, WARM_ITERATIONS)

    def _solve(self, b, max_iter):
        bt = torch.as_tensor(b, device=self.device)
        bn = torch.linalg.norm(bt)
        u, info = self.system.solve(bt / bn, tol=self.tol,
                                    max_iter=max_iter)
        return ((u.double() * bn).cpu().numpy(), int(info.status) == 1,
                int(info.iterations),
                f"own residual {float(info.residual_norm)!r}")

    def diagonal(self) -> np.ndarray:
        return packed_diagonal(self.system)

    def apply_call(self):
        return packed_apply_call(self.system)

    def close(self) -> None:
        self.system = None
