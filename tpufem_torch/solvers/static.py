"""Top-level static driver: mixed solid + shell assembly and a Jacobi PCG
solve (the port of tpufem/solvers/static.py, the reference's
static_structure_solver API).

The state is [N, 6]: solids contribute to the translational columns,
Kirchhoff shells (s3, s4) to all six.  DOFs with no stiffness (the
rotations of a solid model, the drilling theta_z of a shell) are masked
out of the Krylov space by the `live` mask.  Two assembled operators:
"assembled" (MatrixFreeOperator over a ScatterPlan) and "clustered"
(ClusteredOperator, kernels K7a/K7b, for the solid blocks); both on the
element K of solid.stiffness (kernel K6 for k <= 10 types); shells run
elements.shell.ShellOperator.  operator="partial" runs each solid block
on ops.partial.PartialAssemblyOperator (geometry factors, no element K,
affine=False as in tpufem) over a ScatterPlan.  PyTorch runs eagerly, so
there is no jit: setup runs once and cg loops on the device.

operator="packed" solves one solid block on the packed operator
(ops.packed.PackedSystem) and several blocks, or solids with shells, on
ops.packed_mixed.PackedMixedSystem (the largest solid block packed, the
rest bridged through [N, 3] / [N, 6] at each apply); SPC/RBE2/RBE3
through PackedConstraints, PCG as CUDA graphs on the card.  Both return
[N, 6] as tpufem does.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..elements import shell as shell_mod
from ..elements import solid as solid_mod
from ..elements.tables import SHELL_TYPES, SOLID_TYPES
from ..ops.operator import MatrixFreeOperator
from ..ops.scatter import ScatterPlan
from ..utils.profiling import StageClock, span, spanned
from .cg import cg
from .constraints import Constraints

OPERATORS = ("assembled", "clustered", "packed", "partial")


class StaticModel(torch.nn.Module):
    """Assembled mixed-element model: an operator on u [N, 6]."""

    def __init__(self, solid_ops, shell_ops=()):
        super().__init__()
        self.solid_ops = torch.nn.ModuleList(solid_ops)
        self.shell_ops = torch.nn.ModuleList(shell_ops)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        F = torch.zeros_like(u)
        for op in self.solid_ops:
            F[:, :3] += op(u[:, :3])
        for op in self.shell_ops:
            F = F + op(u)
        return F

    def diagonal6(self) -> torch.Tensor:
        """Assembled [N, 6] diagonal (zeros where no stiffness exists)."""
        d6 = None
        for op in self.solid_ops:
            d = op.diagonal().reshape(-1, 3)
            if d6 is None:
                d6 = d.new_zeros((d.shape[0], 6))
            d6[:, :3] += d
        for op in self.shell_ops:
            d = op.diagonal().reshape(-1, 6)
            d6 = d if d6 is None else d6 + d
        return d6

    def jacobi_preconditioner(self, d6: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """Inverse of the [N, 6] diagonal, 0 where it is 0 (pass d6 when
        it is at hand)."""
        d = self.diagonal6() if d6 is None else d6
        return torch.where(d.abs() > 0,
                           1.0 / torch.where(d == 0, 1.0, d), 0.0)


def _check_blocks(blocks: Dict, operator: str) -> None:
    if operator not in OPERATORS:
        raise ValueError(f"operator must be one of {OPERATORS}, got "
                         f"{operator!r}")
    for et in blocks:
        if et.lower() not in SOLID_TYPES + SHELL_TYPES:
            raise ValueError(f"Unsupported element type: {et}")


@spanned("static.build")
def build_static_model(coords, blocks: Dict[str, np.ndarray], material: dict,
                       dtype=None, operator: str = "assembled", device=None,
                       timings: Optional[dict] = None) -> StaticModel:
    """Per-block element stiffness and operators, solid and shell blocks.

    blocks: {etype: connectivity [M, k]} with etype in SOLID_TYPES or
    SHELL_TYPES; material: {'E', 'nu'} for solids, {'membrane', 'bending'}
    ((E, nu, t) triples) for shells; device=None means the CUDA card.
    timings, when given, gets the seconds of each stage ("stiffness",
    "plans", "operator"), each ending in a device synchronise; each is
    also a span (static.stiffness, static.plans, static.operator)."""
    _check_blocks(blocks, operator)
    if operator == "packed":
        raise ValueError("operator='packed' has no assembled model: "
                         "static_structure_solver solves it on PackedSystem "
                         "or PackedMixedSystem")
    dev = resolve_device(device)
    coords_t = torch.as_tensor(coords if isinstance(coords, torch.Tensor)
                               else np.asarray(coords), device=dev)
    if dtype is not None:
        coords_t = coords_t.to(dtype)
    N = coords_t.shape[0]
    t = {"stiffness": 0.0, "plans": 0.0, "operator": 0.0}
    ops, shells = [], []
    for et, conn in blocks.items():
        et = et.lower()
        conn_np = np.asarray(conn)
        conn_t = torch.as_tensor(conn_np, device=dev)
        tick = StageClock(dev, t).tick
        if et in SOLID_TYPES and operator == "partial":
            from ..ops.partial import PartialAssemblyOperator
            with span("static.plans"):
                plan = ScatterPlan.build(conn_np, N, 3, device=dev)
                tick("plans")
            with span("static.operator"):
                ops.append(PartialAssemblyOperator.build(
                    coords_t, conn_np, et, material["E"], material["nu"],
                    plan=plan, affine=False))
                tick("operator")
            continue
        with span("static.stiffness"):
            if et in SHELL_TYPES:
                K = shell_mod.shell_stiffness(coords_t, conn_t,
                                              material["membrane"],
                                              material["bending"])
                unit = shell_mod.local_frames(coords_t, conn_t)
            else:
                K = solid_mod.stiffness(coords_t, conn_t, et, material["E"],
                                        material["nu"])
            tick("stiffness")
        with span("static.plans"):
            if et in SHELL_TYPES:
                plan = ScatterPlan.build(conn_np, N, 6, device=dev)
            elif operator == "clustered":
                from ..ops.clustered import ClusterPlan
                plan = ClusterPlan.build(conn_np, N, 3, device=dev)
            else:
                plan = ScatterPlan.build(conn_np, N, 3, device=dev)
            tick("plans")
        with span("static.operator"):
            if et in SHELL_TYPES:
                shells.append(shell_mod.ShellOperator(K, unit, plan))
            elif operator == "clustered":
                from ..ops.clustered import ClusteredOperator
                ops.append(ClusteredOperator.build(K, conn_np, N, 3,
                                                   plan=plan))
            else:
                ops.append(MatrixFreeOperator(K, plan))
            del K
            tick("operator")
    if timings is not None:
        timings.update(t)
    return StaticModel(ops, shells)


class _LiveConstraints:
    """The user's constraints with the DOFs that have no stiffness also
    projected out of the residual."""

    def __init__(self, cons: Constraints, live: torch.Tensor):
        self.cons, self.live = cons, live

    def project_residual(self, r):
        return self.cons.project_residual(r * self.live)

    def apply_state(self, u):
        return self.cons.apply_state(u)


def static_structure_solver(coords, force, fixed=None, *, material: dict,
                            c3d4=None, c3d6=None, c3d8=None, c3d10=None,
                            c3d20=None, c3d15=None, s3=None, s4=None,
                            blocks: Optional[Dict] = None,
                            constraints: Optional[Constraints] = None,
                            u_init=None, tol: float = 1e-10,
                            max_iter: int = 1000, precondition: bool = False,
                            dtype=None, operator: str = "assembled",
                            dot_dtype=None, device=None,
                            timings: Optional[dict] = None):
    """Solve the mixed static problem; returns (u [N, 6], SolveInfo).

    tpufem's signature (less `jit`): force [N, 6]; fixed nodes pinned in
    all 6 DOFs (or a Constraints over 6 DOFs per node); tol is ABSOLUTE on
    ||r||; dtype defaults to force's; device=None means the CUDA card.
    timings, when given, gets the seconds of the setup stages (see
    build_static_model; PackedMixedSystem's for a mixed packed model, and
    "operator", the whole setup), "jacobi" and "solve"."""
    blocks = dict(blocks or {})
    for name, conn in (("c3d4", c3d4), ("c3d6", c3d6), ("c3d8", c3d8),
                       ("c3d10", c3d10), ("c3d20", c3d20), ("c3d15", c3d15),
                       ("s3", s3), ("s4", s4)):
        if conn is not None:
            blocks[name] = conn
    _check_blocks(blocks, operator)
    dev = resolve_device(device)
    force_t = torch.as_tensor(np.asarray(force) if not isinstance(
        force, torch.Tensor) else force)
    dt = dtype or force_t.dtype
    np_dt = np.float64 if dt == torch.float64 else np.float32
    force_t = force_t.to(device=dev, dtype=dt)
    N = force_t.shape[0]
    if constraints is None:
        constraints = Constraints.fixed(N, fixed if fixed is not None else [],
                                        6, dtype=np_dt)
    if operator == "packed":
        ets = [et.lower() for et in blocks]
        if not any(et in SOLID_TYPES for et in ets):
            raise ValueError("operator='packed' needs >= 1 solid element "
                             f"block, got {ets}")
        solve = _packed_solve if len(ets) == 1 else _packed_mixed_solve
        return solve(coords, force_t, blocks, material, constraints, u_init,
                     tol, max_iter, precondition, dot_dtype, dev, timings)
    model = build_static_model(coords, blocks, material, dtype=dt,
                               operator=operator, device=dev, timings=timings)
    tick = StageClock(dev, timings).tick
    d6 = model.diagonal6()
    live = (d6.abs() > 0).to(dt)
    M_inv = model.jacobi_preconditioner(d6) if precondition else None
    tick("jacobi")
    x0 = (torch.as_tensor(np.asarray(u_init), device=dev).to(dt)
          if u_init is not None else None)
    u, info = cg(model, force_t * live,
                 constraints=_LiveConstraints(constraints, live),
                 M_inv=M_inv, x0=x0, tol=tol, max_iter=max_iter,
                 dot_dtype=dot_dtype)
    tick("solve")
    return u, info


def _packed_solve(coords, force_t, blocks, material, constraints, u_init,
                  tol, max_iter, precondition, dot_dtype, dev, timings):
    """One solid block on the packed operator (tpufem's operator="packed"
    branch): the translations are solved, the rotations stay zero."""
    from ..ops.packed import PackedPartialOperator, PackedSystem
    (et, conn), = blocks.items()
    dt, N = force_t.dtype, force_t.shape[0]
    tick = StageClock(dev, timings).tick
    op = PackedPartialOperator.build(
        np.asarray(coords), np.asarray(conn), et.lower(), material["E"],
        material["nu"], n_nodes=N, dtype=dt, device=dev)
    system = PackedSystem(
        op, constraints=constraints,
        precondition=(precondition if isinstance(precondition, str)
                      else ("jacobi" if precondition else None)))
    tick("operator")
    x0 = (torch.as_tensor(np.asarray(u_init)[:, :3], dtype=dt, device=dev)
          if u_init is not None else None)
    u3, info = system.solve(force_t[:, :3], x0=x0, tol=tol,
                            max_iter=max_iter, dot_dtype=dot_dtype)
    u6 = u3.new_zeros((N, 6))
    u6[:, :3] = u3
    tick("solve")
    return u6, info


def _packed_mixed_solve(coords, force_t, blocks, material, constraints,
                        u_init, tol, max_iter, precondition, dot_dtype, dev,
                        timings):
    """Several solid blocks, or solids and shells, on the packed layout
    (ops.packed_mixed.PackedMixedSystem, tpufem's mixed packed branch)."""
    from ..ops.packed_mixed import PackedMixedSystem
    N = force_t.shape[0]
    tick = StageClock(dev, timings).tick
    system = PackedMixedSystem(coords, blocks, material, n_nodes=N,
                               constraints=constraints,
                               precondition=bool(precondition),
                               dtype=force_t.dtype, device=dev)
    tick("operator")
    u6, info = system.solve(force_t, x0=u_init, tol=tol, max_iter=max_iter,
                            dot_dtype=dot_dtype)
    tick("solve")
    if timings is not None:
        timings.update(system.timings)
    return u6, info
