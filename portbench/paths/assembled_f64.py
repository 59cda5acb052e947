"""The assembled clustered float64 static solve.

What ``static_structure_solver(operator="clustered", precondition=True)``
builds, built once through the program's public names:
``build_static_model`` (element stiffness by kernel stiffness_fused, the
cluster plan, the clustered operator on kernels cluster_expand and
cluster_compress), the [N, 6] state with the DOFs that have no stiffness
masked, the Jacobi preconditioner and the fixed nodes pinned in all six
DOFs; then one ``CGBlock`` (its 32-iteration blocks CUDA graphs, captured
by the warm solve) solves every case, its load scaled to unit norm so
that one block serves every case at the traffic's relative tolerance,
and the answer is scaled back.

The control is the same path in float32.
"""
from __future__ import annotations

import numpy as np
import torch

OPERATOR = "assembled"
DTYPE = "float64"
# largest relative difference of the float64 diagonal from the reference's
# (PERF.md gives the readings it was set from)
DIAG_LIMIT = 1e-9
# the warm solve's cap: two of the PCG's 32-iteration graph blocks (the
# first captures the graph)
WARM_ITERATIONS = 64


class LiveConstraints:
    """The fixed nodes' constraints with the DOFs that have no stiffness
    (the rotations of solid-only nodes) also projected out of the
    residual, as the static solver's own wrapper does."""

    def __init__(self, cons, live: torch.Tensor):
        self.cons, self.live = cons, live

    def project_residual(self, r):
        return self.cons.project_residual(r * self.live)

    def apply_state(self, u):
        return self.cons.apply_state(u)


class Path:
    def __init__(self, mesh, config, traffic, device, stages, control=False):
        import tpufem_torch as tt
        from tpufem_torch.solvers.cg import CGBlock

        E, nu = config["material"]["E"], config["material"]["nu"]
        etype = config["element"]["type"]
        self.dtype = torch.float32 if control else torch.float64
        self.tol = float(traffic["tol_rel"])
        self.max_iter = int(traffic["max_iter"])
        N = mesh.coords.shape[0]
        self.device = device
        with stages("assembly"):
            self.model = tt.build_static_model(
                mesh.coords, {etype: mesh.conn}, {"E": E, "nu": nu},
                dtype=self.dtype, operator="clustered", device=device)
        with stages("system"):
            d6 = self.model.diagonal6()
            self.live = (d6.abs() > 0).to(self.dtype)
            minv = self.model.jacobi_preconditioner(d6)
            del d6
            npdt = np.float32 if control else np.float64
            cons = tt.Constraints.fixed(N, mesh.fixed, 6, dtype=npdt)
            self.block = CGBlock(
                self.model, torch.zeros((N, 6), dtype=self.dtype,
                                        device=device),
                constraints=LiveConstraints(cons, self.live), M_inv=minv,
                tol=self.tol)
            # one eager apply: the element GEMV's library handle is made
            # before the warm solve captures the PCG's graphs
            self.model(torch.zeros_like(self.live))

    def solve(self, b: np.ndarray):
        return self._solve(b, self.max_iter)

    def warm(self, b: np.ndarray) -> None:
        self._solve(b, WARM_ITERATIONS)

    def _solve(self, b, max_iter):
        bt = torch.as_tensor(b, device=self.device)
        bn = torch.linalg.norm(bt)
        b6 = torch.zeros_like(self.live)
        b6[:, :3] = bt / bn
        u6, info = self.block.solve(b6 * self.live, max_iter=max_iter)
        return ((u6[:, :3].double() * bn).cpu().numpy(),
                int(info.status) == 1, int(info.iterations),
                f"own residual {float(info.residual_norm)!r}")

    def diagonal(self) -> np.ndarray:
        return self.model.diagonal6()[:, :3].double().cpu().numpy()

    def apply_call(self):
        g = torch.Generator(device=self.live.device).manual_seed(0)
        u6 = torch.randn(self.live.shape, generator=g, dtype=self.dtype,
                         device=self.live.device)
        return lambda: self.model(u6)

    def close(self) -> None:
        self.model = self.block = self.live = None
