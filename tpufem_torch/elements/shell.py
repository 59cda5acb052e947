"""Kirchhoff shell elements s3/s4: frames, stiffness, stress, operator (the
port of tpufem/elements/shell.py).

Every shell element carries a local orthonormal frame (node 0 the origin,
node 0 -> node 1 the x axis, Gram-Schmidt y, z = x cross y).  The DOFs of
a node are [u, v, w, theta_x, theta_y, theta_z] in GLOBAL coordinates; the
operator rotates them to the local frame, applies the local 6k x 6k
stiffness and rotates the forces back.

B-matrix rows (tpufem's, which are the reference's):

    membrane rows 0-2:  e_xx = N,x u;  e_yy = N,y v;  g_xy = N,y u + N,x v
    bending  rows 3-5:  k_xx = -N,x th_y; k_yy = N,y th_x;
                        k_xy =  N,y th_x + N,x th_y
    (the drilling theta_z carries no stiffness: classical Kirchhoff)

tpufem runs these as XLA einsums and takes outside any Pallas kernel; here
they are torch.einsum and indexing (TF32 is off, so a float32 contraction
runs in full float32, the analogue of tpufem's Precision.HIGHEST).
Stress recovery averages B over the quadrature with normalized weights,
tpufem's deviation from the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.materials import kirchhoff_D_matrix
from ..ops.scatter import ScatterPlan
from .tables import ElementTable, element_table


def _idx(conn) -> torch.Tensor:
    return torch.as_tensor(conn).long()


def _const(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Local frames and coordinates
# ---------------------------------------------------------------------------

def local_frames(coords: torch.Tensor, conn, dtype=None) -> torch.Tensor:
    """unit [M, 3, 3]: rows are the local x/y/z axes in global
    coordinates (s4 takes its axes from nodes 0, 1 and 3)."""
    dtype = dtype or coords.dtype
    c = coords.to(dtype)
    conn = _idx(conn).to(c.device)
    k = conn.shape[1]
    a = c[conn[:, 1]] - c[conn[:, 0]]
    b_ref = c[conn[:, 3 if k == 4 else 2]] - c[conn[:, 0]]
    b = b_ref - (torch.sum(a * b_ref, dim=1, keepdim=True)
                 / torch.sum(a * a, dim=1, keepdim=True)) * a
    a = a / torch.linalg.norm(a, dim=1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=1, keepdim=True)
    return torch.stack([a, b, torch.linalg.cross(a, b, dim=1)], dim=1)


def local_coordinates(coords: torch.Tensor, conn, unit: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """In-frame nodal coordinates [M, k, 3] (node 0 at the origin)."""
    dtype = dtype or coords.dtype
    g = coords.to(dtype)[_idx(conn).to(coords.device)]      # [M, k, 3]
    v = g - g[:, 0:1, :]
    return torch.einsum("mna,mda->mnd", v, unit.to(dtype))


def shell_normals(coords: torch.Tensor, conn, dtype=None) -> torch.Tensor:
    """Area-scaled facet normal [M, 3] (tri: cross / 2; quad: the cross
    product of the edges from node 0)."""
    dtype = dtype or coords.dtype
    c = coords.to(dtype)
    conn = _idx(conn).to(c.device)
    k = conn.shape[1]
    a = c[conn[:, 1]] - c[conn[:, 0]]
    b = c[conn[:, 3 if k == 4 else 2]] - c[conn[:, 0]]
    n = torch.linalg.cross(a, b, dim=1)
    return 0.5 * n if k == 3 else n


# ---------------------------------------------------------------------------
# In-plane geometry and B
# ---------------------------------------------------------------------------

def _inplane_gradients(xy: torch.Tensor, table: ElementTable, dtype):
    """(dN_xy [M, q, k, 2], detJ [M, q]) from in-plane coordinates
    xy [M, k, 2]."""
    dN = _const(table.dN, dtype, xy.device)               # [q, k, 2]
    J = torch.einsum("qka,mkb->mqab", dN, xy)            # [M, q, 2, 2]
    detJ = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    inv00 = J[..., 1, 1] / detJ
    inv01 = -J[..., 0, 1] / detJ
    inv10 = -J[..., 1, 0] / detJ
    inv11 = J[..., 0, 0] / detJ
    Jinv = torch.stack([torch.stack([inv00, inv01], dim=-1),
                        torch.stack([inv10, inv11], dim=-1)], dim=-2)
    return torch.einsum("mqij,qkj->mqki", Jinv, dN), detJ


def shell_b_matrix(g: torch.Tensor) -> torch.Tensor:
    """B [M, q, 6, k, 6] from in-plane gradients g [M, q, k, 2]."""
    gx, gy = g[..., 0], g[..., 1]                        # [M, q, k]
    z = torch.zeros_like(gx)
    # columns: (u, v, w, thx, thy, thz)
    rows = [
        torch.stack([gx, z, z, z, z, z], dim=-1),
        torch.stack([z, gy, z, z, z, z], dim=-1),
        torch.stack([gy, gx, z, z, z, z], dim=-1),
        torch.stack([z, z, z, z, -gx, z], dim=-1),
        torch.stack([z, z, z, gy, z, z], dim=-1),
        torch.stack([z, z, z, gy, gx, z], dim=-1),
    ]
    return torch.stack(rows, dim=2)


# ---------------------------------------------------------------------------
# Stiffness and stress
# ---------------------------------------------------------------------------

def _resolve(coords, conn, etype, table, dtype):
    etype = etype or ("s3" if np.shape(conn)[1] == 3 else "s4")
    table = table or element_table(etype)
    dtype = dtype or coords.dtype
    return etype, table, dtype


def shell_stiffness(coords: torch.Tensor, conn, membrane, bending,
                    etype: Optional[str] = None,
                    table: Optional[ElementTable] = None, dtype=None,
                    unit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Local-frame shell stiffness K [M, 6k, 6k]."""
    etype, table, dtype = _resolve(coords, conn, etype, table, dtype)
    if unit is None:
        unit = local_frames(coords, conn, dtype)
    xy = local_coordinates(coords, conn, unit, dtype)[..., :2]
    g, detJ = _inplane_gradients(xy, table, dtype)
    B = shell_b_matrix(g)                                  # [M, q, 6, k, 6]
    D = _const(kirchhoff_D_matrix(membrane, bending), dtype, xy.device)
    W = _const(table.weights, dtype, xy.device)[None, :] * detJ
    K = torch.einsum("mq,mqria,rs,mqsjb->miajb", W, B, D, B)
    k = table.n_nodes
    return K.reshape(K.shape[0], 6 * k, 6 * k)


def shell_stress(coords: torch.Tensor, conn, membrane, bending,
                 displacement: torch.Tensor, etype: Optional[str] = None,
                 table: Optional[ElementTable] = None, dtype=None,
                 unit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NMQ stress resultants [M, 6] = D @ (mean_q B) @ u_local."""
    etype, table, dtype = _resolve(coords, conn, etype, table, dtype)
    if unit is None:
        unit = local_frames(coords, conn, dtype)
    xy = local_coordinates(coords, conn, unit, dtype)[..., :2]
    g, _ = _inplane_gradients(xy, table, dtype)
    B = shell_b_matrix(g)
    w = _const(table.weights, dtype, xy.device)
    Bavg = torch.einsum("q,mqria->mria", w, B) / torch.sum(w)
    u_loc = global_to_local_displacement(conn, displacement, unit, dtype)
    strain = torch.einsum("mria,mia->mr", Bavg, u_loc)
    D = _const(kirchhoff_D_matrix(membrane, bending), dtype, xy.device)
    return torch.einsum("rs,ms->mr", D, strain)


# ---------------------------------------------------------------------------
# Frame rotation and the matrix-free operator
# ---------------------------------------------------------------------------

def global_to_local_displacement(conn, displacement: torch.Tensor,
                                 unit: torch.Tensor, dtype=None
                                 ) -> torch.Tensor:
    """[N, 6] global displacement -> per-element local [M, k, 6]."""
    dtype = dtype or displacement.dtype
    ge = displacement.to(dtype)[_idx(conn).to(displacement.device)]
    u = unit.to(dtype)
    t = torch.einsum("mkj,mdj->mkd", ge[..., :3], u)
    r = torch.einsum("mkj,mdj->mkd", ge[..., 3:], u)
    return torch.cat([t, r], dim=-1)


def shell_nodal_forces(K: torch.Tensor, plan_or_conn,
                       displacement: torch.Tensor, unit: torch.Tensor,
                       n_nodes: Optional[int] = None) -> torch.Tensor:
    """F [N, 6] = scatter(unit^T @ (K_local @ (unit @ u_e))), through the
    plan's deterministic scatter (a plan is built on the displacement's
    device when connectivity is given)."""
    if isinstance(plan_or_conn, ScatterPlan):
        plan = plan_or_conn
    else:
        n = int(displacement.shape[0]) if n_nodes is None else n_nodes
        conn = plan_or_conn
        if isinstance(conn, torch.Tensor):
            conn = conn.cpu().numpy()
        plan = ScatterPlan.build(np.asarray(conn), n, 6,
                                 device=displacement.device)
    M, d, _ = K.shape
    k = d // 6
    u2d = displacement.reshape(-1, 6)
    u_loc = global_to_local_displacement(plan.conn, u2d, unit,
                                         displacement.dtype)   # [M, k, 6]
    F_loc = torch.einsum("mij,mj->mi", K, u_loc.reshape(M, d)).reshape(
        M, k, 6)
    uT = unit.transpose(1, 2).to(displacement.dtype)
    Ft = torch.einsum("mab,mkb->mka", uT, F_loc[..., :3])
    Fr = torch.einsum("mab,mkb->mka", uT, F_loc[..., 3:])
    Fe = torch.cat([Ft, Fr], dim=-1)                       # [M, k, 6]
    return plan.scatter(Fe.reshape(M, d)).reshape(u2d.shape)


def shell_operator_diagonal(K: torch.Tensor, unit: torch.Tensor
                            ) -> torch.Tensor:
    """Global-frame assembled-diagonal contribution [M, 6k] of a shell
    block."""
    M, d, _ = K.shape
    k = d // 6
    Kl = K.reshape(M, k, 6, k, 6)
    u = unit.to(K.dtype)
    # per-node 3x3 diagonal blocks for translations and rotations
    Kt = torch.einsum("mibic->mibc", Kl[:, :, :3, :, :3])   # [M, k, 3, 3]
    Kr = torch.einsum("mibic->mibc", Kl[:, :, 3:, :, 3:])
    dt = torch.einsum("mba,mkbc,mca->mka", u, Kt, u)        # [M, k, 3]
    dr = torch.einsum("mba,mkbc,mca->mka", u, Kr, u)
    return torch.cat([dt, dr], dim=-1).reshape(M, d)


class ShellOperator(torch.nn.Module):
    """u [N, 6] -> F [N, 6], the matrix-free shell operator (frame
    rotation around the local stiffness).  K [M, 6k, 6k] and unit
    [M, 3, 3] are buffers on the plan's device; plan is a 6-DOF
    ScatterPlan."""

    def __init__(self, K: torch.Tensor, unit: torch.Tensor,
                 plan: ScatterPlan):
        super().__init__()
        self.register_buffer("K", torch.as_tensor(K).to(plan.device))
        self.register_buffer("unit", torch.as_tensor(unit).to(plan.device))
        self.plan = plan

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return shell_nodal_forces(self.K, self.plan, u, self.unit)

    def diagonal(self) -> torch.Tensor:
        """Assembled GLOBAL-frame diagonal [n_dof] (see
        shell_operator_diagonal)."""
        return self.plan.scatter(shell_operator_diagonal(self.K, self.unit))


def shell_postprocess_values(NMQ: torch.Tensor, t: float, z: float = 0.0,
                             eps: float = 1e-30) -> dict:
    """Through-thickness stresses and principal values from NMQ
    resultants: sx, sy, txy, s1, s2, theta_p, tau_max, vm_stress."""
    Nxx, Nyy, Nxy = NMQ[:, 0], NMQ[:, 1], NMQ[:, 2]
    Mxx, Myy, Mxy = NMQ[:, 3], NMQ[:, 4], NMQ[:, 5]
    f1 = 1.0 / t
    f2 = 6.0 * z / (t * t)
    sx = Nxx * f1 + Mxx * f2
    sy = Nyy * f1 + Myy * f2
    txy = Nxy * f1 + Mxy * f2
    half = 0.5 * (sx + sy)
    R = torch.sqrt((0.5 * (sx - sy)) ** 2 + txy**2)
    s1, s2 = half + R, half - R
    theta_p = 0.5 * torch.atan2(2.0 * txy, torch.clamp(sx - sy, min=eps))
    return {
        "sx": sx, "sy": sy, "txy": txy, "s1": s1, "s2": s2,
        "theta_p": theta_p, "tau_max": 0.5 * (s1 - s2),
        "vm_stress": torch.sqrt(s1 * s1 - s1 * s2 + s2 * s2 + eps),
    }
