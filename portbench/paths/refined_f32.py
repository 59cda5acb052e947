"""The refined f32 packed solve: tpufem's flagship path.

``RefinedSystem.solve`` over a ``PackedSystem`` in float32 (scalar Jacobi,
the z = 0 face fixed): float32 packed PCG inner solves (kernels fused_yc
and combine in every apply, each 32-iteration block a CUDA graph) under
the float64 true-residual outer loop, with the settings of tpufem's
``solve_scale`` script below n = 100 (inner tolerance 5e-3, chunks of
500, at most 1500 inner iterations a cycle).

The control is the program's float32 packed PCG alone (``PackedSystem.
solve`` on the same system, no float64 outer loop) asked for the same
accuracy.
"""
from __future__ import annotations

import numpy as np
import torch

from . import packed_apply_call, packed_diagonal

OPERATOR = "packed"
DTYPE = "float32"
# the float32 diagonal preconditions the inner solves only, and the control
# (the same float32 system) shares it: printed, not compared
DIAG_LIMIT = None
INNER = dict(inner_tol=5e-3, every=500, inner_max_iter=1500)
# the control's warm solve's cap: two of the PCG's 32-iteration graph blocks
WARM_ITERATIONS = 64


class Path:
    def __init__(self, mesh, config, traffic, device, stages, control=False):
        import tpufem_torch as tt

        E, nu = config["material"]["E"], config["material"]["nu"]
        etype = config["element"]["type"]
        self.tol = float(traffic["tol_rel"])
        self.max_iter = int(traffic["max_iter"])
        self.control = control
        self.device = device
        self.N = mesh.coords.shape[0]
        with stages("plan"):
            plan = tt.PackedPlan.build(mesh.coords, mesh.conn, self.N,
                                       device=device)
        with stages("operator"):
            op = tt.PackedPartialOperator.build(
                mesh.coords, mesh.conn, etype, E, nu, plan=plan,
                dtype=torch.float32, device=device)
        with stages("system"):
            self.system = tt.PackedSystem(op, fixed_nodes=mesh.fixed,
                                          precondition="jacobi")
        self.refined = None
        if control:
            with stages("capture"):
                self.system.warm(tol=self.tol, max_iter=self.max_iter)
            return
        with stages("refine_geometry"):
            self.refined = tt.RefinedSystem(self.system, mesh.coords,
                                            mesh.conn, etype, E, nu)
        with stages("capture"):
            self.system.warm_chunked(tol=INNER["inner_tol"],
                                     every=INNER["every"])

    def solve(self, b: np.ndarray):
        return self._solve(b, warm=False)

    def warm(self, b: np.ndarray) -> None:
        self._solve(b, warm=True)

    def _solve(self, b, warm):
        if self.control:
            bt = torch.as_tensor(b, device=self.device)
            bn = torch.linalg.norm(bt)
            u, info = self.system.solve(
                bt / bn, tol=self.tol,
                max_iter=WARM_ITERATIONS if warm else self.max_iter)
            return ((u.double() * bn).cpu().numpy(), int(info.status) == 1,
                    int(info.iterations),
                    f"own residual {float(info.residual_norm)!r}")
        # warm: one outer cycle of one inner chunk (both graph sizes)
        kw = (dict(INNER, inner_max_iter=INNER["every"], max_cycles=1)
              if warm else INNER)
        u, info = self.refined.solve(b, tol_rel=self.tol, **kw)
        return (u.reshape(self.N, 3).cpu().numpy(), bool(info.converged),
                int(info.inner_iterations),
                f"cycles {info.cycles} own residual {info.rel_residual!r}")

    def diagonal(self) -> np.ndarray:
        return packed_diagonal(self.system)

    def apply_call(self):
        return packed_apply_call(self.system)

    def close(self) -> None:
        self.system = self.refined = None
