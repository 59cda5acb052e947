"""Mixed solid + shell systems on the packed layout (the port of
tpufem/ops/packed_mixed.py).

The LARGEST solid block (by element DOFs) rides the packed partial-
assembly operator (kernels K1-K3; its plan defines the node renumbering
and the [Nb, 384] tile layout).  The other solid blocks (assembled element
K: kernel K6 for k <= 10 types) and the shell blocks bridge through the
[N, 3] / [N, 6] view once per apply.  The PCG state is [P, Nb, 384] with
P = 1 (solids only) or 2 (plane 0 the translations, plane 1 the
rotations), so every elementwise pass of the solver is a dense packed-tile
pass; only the secondary blocks pay the unpack/pack bridge.  The bridge
reads nothing on the host, so the PCG blocks (solvers.cg.CGBlock) are
captured as CUDA graphs on the card.

Constraints: each plane carries its own rows of a
solvers.constraints.Constraints (PackedConstraints.build(comp=0|3); the
reference's RBE2/RBE3 couple component-wise).  DOFs with no stiffness
(rotations away from shells, the drilling theta_z) are folded into each
plane's mask, so they stay out of the Krylov space, as the assembled
driver's `live` mask keeps them out (solvers/static.py).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..elements.tables import SHELL_TYPES, SOLID_TYPES
from ..utils.profiling import StageClock
from .operator import MatrixFreeOperator
from .packed import PackedConstraints, PackedPartialOperator
from .scatter import ScatterPlan


class PackedMixedOperator(torch.nn.Module):
    """X [P, Nb, 384] -> K X in the same layout (P = 1 or 2 planes)."""

    def __init__(self, primary: PackedPartialOperator, solids=(), shells=()):
        super().__init__()
        self.primary = primary
        self.solids = torch.nn.ModuleList(solids)
        self.shells = torch.nn.ModuleList(shells)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        plan = self.primary.plan
        Yt = self.primary(X[0])
        Yr = None
        if len(self.solids) or len(self.shells):
            u3 = plan.unpack(X[0])
            F3 = torch.zeros_like(u3)
            for op in self.solids:
                F3 = F3 + op(u3)
            if len(self.shells):
                u6 = torch.cat([u3, plan.unpack(X[1])], dim=1)
                F6 = self.shells[0](u6)
                for op in self.shells[1:]:
                    F6 = F6 + op(u6)
                F3 = F3 + F6[:, :3]
                Yr = plan.pack(F6[:, 3:])
            Yt = Yt + plan.pack(F3)
        if X.shape[0] == 1:
            return Yt[None]
        if Yr is None:
            Yr = torch.zeros_like(Yt)
        return torch.stack([Yt, Yr])

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal in the packed [P, Nb, 384] layout."""
        plan = self.primary.plan
        dt = self.primary.diagonal()
        d3 = dt.new_zeros((plan.meta.n_nodes, 3))
        dr6 = None
        for op in self.solids:
            d3 = d3 + op.diagonal().reshape(-1, 3).to(dt.dtype)
        for op in self.shells:
            d6 = op.diagonal().reshape(-1, 6).to(dt.dtype)
            d3 = d3 + d6[:, :3]
            dr6 = d6[:, 3:] if dr6 is None else dr6 + d6[:, 3:]
        dt = dt + plan.pack(d3)
        if dr6 is None:
            return dt[None]
        return torch.stack([dt, plan.pack(dr6)])


class MixedConstraints:
    """Per-plane PackedConstraints with the live-DOF mask folded in."""

    def __init__(self, planes):
        self.planes = tuple(planes)

    def apply_state(self, X: torch.Tensor) -> torch.Tensor:
        return torch.stack([pc.apply_state(X[i])
                            for i, pc in enumerate(self.planes)])

    def project_residual(self, r: torch.Tensor) -> torch.Tensor:
        return torch.stack([pc.project_residual(r[i])
                            for i, pc in enumerate(self.planes)])


def _torch_dtype(dtype, default: np.dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype or default))).dtype


class PackedMixedSystem:
    """One-call mixed static system on the packed layout.

    blocks: {etype: connectivity} with >= 1 solid block and any number of
    shell blocks; material: the reference dict ({'E', 'nu', 'membrane':
    (E, nu, t), 'bending': (E, nu, t)}); device=None means the CUDA card.
    `timings` holds the setup seconds by stage (each ending in a device
    synchronise): "primary" (packed plan and geometry), "solids" (the
    secondary blocks' K and plans), "shells", "constraints", "diagonal".
    """

    def __init__(self, coords, blocks: Dict[str, np.ndarray],
                 material: dict, n_nodes: Optional[int] = None,
                 constraints=None, fixed_nodes=None,
                 precondition: bool = True, dtype=None, device=None):
        from ..elements import shell as shell_mod
        from ..elements import solid as solid_mod
        from ..solvers.constraints import Constraints

        dev = resolve_device(device)
        blocks = {et.lower(): np.asarray(c) for et, c in blocks.items()}
        solids = {et: c for et, c in blocks.items() if et in SOLID_TYPES}
        shells = {et: c for et, c in blocks.items() if et in SHELL_TYPES}
        if not solids:
            raise ValueError("PackedMixedSystem needs >= 1 solid block "
                             f"(got {list(blocks)}); pure-shell models run "
                             "through static_structure_solver's assembled "
                             "path")
        unknown = set(blocks) - set(solids) - set(shells)
        if unknown:
            raise ValueError(f"unsupported element types: {sorted(unknown)}")
        coords_np = (coords.cpu().numpy() if isinstance(coords, torch.Tensor)
                     else np.asarray(coords))
        N = int(n_nodes) if n_nodes is not None else coords_np.shape[0]
        dt = _torch_dtype(dtype, coords_np.dtype)
        np_dt = torch.empty((), dtype=dt).numpy().dtype
        coords_t = torch.as_tensor(coords_np, device=dev).to(dt)
        self.timings = {}
        tick = StageClock(dev, self.timings).tick

        # primary = the solid block with the most element DOFs
        primary_et = max(solids, key=lambda et: solids[et].size)
        prim = PackedPartialOperator.build(
            coords_np, solids[primary_et], primary_et, material["E"],
            material["nu"], n_nodes=N, dtype=dt, device=dev)
        tick("primary")
        sec = []
        for et, c in solids.items():
            if et == primary_et:
                continue
            K = solid_mod.stiffness(coords_t, torch.as_tensor(c, device=dev),
                                    et, material["E"], material["nu"])
            sec.append(MatrixFreeOperator(K, ScatterPlan.build(c, N, 3,
                                                               device=dev)))
            del K
        tick("solids")
        sh = []
        for et, c in shells.items():
            ct = torch.as_tensor(c, device=dev)
            K = shell_mod.shell_stiffness(coords_t, ct, material["membrane"],
                                          material["bending"])
            unit = shell_mod.local_frames(coords_t, ct)
            sh.append(shell_mod.ShellOperator(
                K, unit, ScatterPlan.build(c, N, 6, device=dev)))
        tick("shells")
        self.op = PackedMixedOperator(prim, sec, sh)
        self.has_rot = bool(sh)
        self.dtype = dt

        nd = 6 if self.has_rot else 3
        if constraints is None:
            constraints = Constraints.fixed(
                N, fixed_nodes if fixed_nodes is not None else [], nd,
                dtype=np_dt)
        if constraints.dof_per_node < nd:
            raise ValueError(
                f"constraints carry {constraints.dof_per_node} DOF/node but "
                f"the model has shells (needs {nd})")
        plan = prim.plan
        pcs = [PackedConstraints.build(constraints, plan, dt, comp=0)]
        if self.has_rot:
            pcs.append(PackedConstraints.build(constraints, plan, dt,
                                               comp=3))
        tick("constraints")
        # DOFs with a zero assembled diagonal (rotations away from shells,
        # the drilling theta_z) stay out of the Krylov space
        diag = self.op.diagonal()
        live = (torch.abs(diag) > 0).to(dt)
        planes = []
        for i, pc in enumerate(pcs):
            pc = copy.copy(pc)
            pc.mask = pc.mask * live[i]
            planes.append(pc)
        self.pc = MixedConstraints(planes)
        if precondition:
            minv = torch.where(torch.abs(diag) > 0,
                               1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
            self.M_inv = minv * torch.stack([pc.mask for pc in planes])
        else:
            self.M_inv = None
        tick("diagonal")
        self._blocks = {}

    # ------------------------------------------------------------------
    def pack6(self, v) -> torch.Tensor:
        """[N, >= 3] field (host or device) -> [P, Nb, 384]."""
        plan = self.op.primary.plan
        v = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.asarray(v)).to(device=plan.device,
                                                   dtype=self.dtype)
        planes = [plan.pack(v[:, :3])]
        if self.has_rot:
            planes.append(plan.pack(v[:, 3:6]) if v.shape[1] >= 6
                          else torch.zeros_like(planes[0]))
        return torch.stack(planes)

    def unpack6(self, X: torch.Tensor) -> torch.Tensor:
        """[P, Nb, 384] -> [N, 6] (zero rotations without shells)."""
        plan = self.op.primary.plan
        u3 = plan.unpack(X[0])
        ur = plan.unpack(X[1]) if self.has_rot else torch.zeros_like(u3)
        return torch.cat([u3, ur], dim=1)

    def block(self, tol: float, dot_dtype=None):
        """The CGBlock of this (tol, dot_dtype), made at first use (on
        the card its graphs are captured once and replayed by every
        solve)."""
        from ..solvers.cg import CGBlock
        key = (float(tol), str(dot_dtype))
        if key not in self._blocks:
            like = torch.zeros_like(self.pc.planes[0].mask).expand(
                len(self.pc.planes), -1, -1).contiguous()
            self._blocks[key] = CGBlock(
                self.op, like, constraints=self.pc, M_inv=self.M_inv,
                tol=tol, dot_dtype=dot_dtype)
        return self._blocks[key]

    def solve(self, b, x0=None, tol: float = 1e-8, max_iter: int = 1000,
              dot_dtype=None):
        """b [N, >= 3] -> (u [N, 6], SolveInfo); tol is absolute on ||r||
        of the packed residual."""
        bX = self.pack6(b)
        x0X = self.pack6(x0) if x0 is not None else None
        uX, info = self.block(tol, dot_dtype).solve(
            self.pc.project_residual(bX), x0=x0X, max_iter=max_iter)
        return self.unpack6(uX), info
