"""Batched solid-element kernels (stiffness / mass / stress) in torch.

The port of tpufem/elements/solid.py.  Every stage is a batched einsum over
all M elements and q integration points, as in tpufem, where XLA runs them
outside any kernel; with TF32 off (tpufem_torch/__init__.py) a float32
contraction runs in full float32 on the card.  The one kernel is the
element stiffness for k <= 10 types: `stiffness` routes those to
ops.stiffness_kernels.stiffness_fused (the CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor), everything else to the B^T D B
pipeline `stiffness_bmat`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.materials import elasticity_matrix, lame_parameters
from ..core.voigt import stress_tensor, von_mises
from .tables import ElementTable, element_table


def _const(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# 3x3 helpers (explicit adjugate)
# ---------------------------------------------------------------------------

def det3x3(J: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3]."""
    return (
        J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
        - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
        + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
    )


def inv3x3(J: torch.Tensor, det: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of [..., 3, 3] via the adjugate; optionally reuse det."""
    if det is None:
        det = det3x3(J)
    c00 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
    c01 = J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2]
    c02 = J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]
    c10 = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
    c11 = J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0]
    c12 = J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]
    c20 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
    c21 = J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1]
    c22 = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    adj = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c10, c11, c12], dim=-1),
        torch.stack([c20, c21, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


# ---------------------------------------------------------------------------
# Geometry: Jacobians and physical shape gradients
# ---------------------------------------------------------------------------

def jacobians(coords: torch.Tensor, conn: torch.Tensor, table: ElementTable,
              dtype=None) -> torch.Tensor:
    """J[M, q, 3, 3] with J[a, b] = d x_b / d xi_a."""
    dtype = dtype or coords.dtype
    Xe = coords[conn.long()].to(dtype)                    # [M, k, 3]
    dN = _const(table.dN, dtype, coords.device)
    return torch.einsum("qka,mkb->mqab", dN, Xe)


def shape_gradients_from_J(J: torch.Tensor, table: ElementTable, dtype=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g [M, q, k, 3] physical gradients dN_k/dx at every ip, detJ)."""
    dtype = dtype or J.dtype
    detJ = det3x3(J)
    Jinv = inv3x3(J, detJ)
    dN = _const(table.dN, dtype, J.device)
    g = torch.einsum("mqij,qkj->mqki", Jinv, dN)
    return g, detJ


def shape_gradients(coords, conn, table: ElementTable, dtype=None):
    J = jacobians(coords, conn, table, dtype)
    return shape_gradients_from_J(J, table, dtype)


def volumes(coords, conn, table: Optional[ElementTable] = None,
            etype: Optional[str] = None) -> torch.Tensor:
    """Element volumes = sum_q w detJ (exact for affine geometry)."""
    if table is None:
        table = element_table(etype)
    J = jacobians(coords, conn, table)
    detJ = det3x3(J)
    w = _const(table.weights, detJ.dtype, detJ.device)
    return torch.einsum("q,mq->m", w, detJ)


# ---------------------------------------------------------------------------
# B-matrix
# ---------------------------------------------------------------------------

_VOIGT_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (2, 0))


def _packed_b_coeffs(table: ElementTable, dtype=np.float64) -> np.ndarray:
    """CB[q, 3, 3, 6, 3k]: constant tensor with B = einsum(Jinv, CB).

    B[m,q,r,(3i+a)] = sum_{c,j} Jinv[m,q,c,j] * CB[q,c,j,r,3i+a] is the
    Voigt B matrix in the [M, q, 6, 3k] layout, from one contraction."""
    dN = np.asarray(table.dN, dtype)                    # [q, k, 3]
    q, k, _ = dN.shape
    CB = np.zeros((q, 3, 3, 6, 3 * k), dtype)
    for r, (p0, p1) in enumerate(_VOIGT_PAIRS):
        for j in range(3):
            if r < 3:
                CB[:, p0, j, r, p0::3] += dN[:, :, j]
            else:
                CB[:, p1, j, r, p0::3] += dN[:, :, j]
                CB[:, p0, j, r, p1::3] += dN[:, :, j]
    return CB


def b_matrix_from_gradients(g: torch.Tensor) -> torch.Tensor:
    """B[M, q, 6, k, 3] from gradients g[M, q, k, 3].

    Rows: [e_xx, e_yy, e_zz, g_xy, g_yz, g_zx]."""
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]       # [M, q, k]
    zero = torch.zeros_like(gx)
    rows = [
        torch.stack([gx, zero, zero], dim=-1),
        torch.stack([zero, gy, zero], dim=-1),
        torch.stack([zero, zero, gz], dim=-1),
        torch.stack([gy, gx, zero], dim=-1),
        torch.stack([zero, gz, gy], dim=-1),
        torch.stack([gz, zero, gx], dim=-1),
    ]
    return torch.stack(rows, dim=2)                     # [M, q, 6, k, 3]


def _packed_B_and_W(coords, conn, table, dtype):
    """(B [M,q,6,3k], W = w*detJ [M,q], detJ [M,q])."""
    J = jacobians(coords, conn, table, dtype)
    detJ = det3x3(J)
    Jinv = inv3x3(J, detJ)
    CB = _const(_packed_b_coeffs(table), dtype, J.device)
    B = torch.einsum("mqcj,qcjri->mqri", Jinv, CB)
    W = _const(table.weights, dtype, J.device)[None, :] * detJ
    return B, W, detJ


# ---------------------------------------------------------------------------
# Stiffness
# ---------------------------------------------------------------------------

def stiffness(coords, conn, etype: str, E: float, nu: float,
              rule: str = "default", table: Optional[ElementTable] = None,
              dtype=None, fused: Optional[bool] = None) -> torch.Tensor:
    """Element stiffness K[M, 3k, 3k], isotropic.

    fused=None: a k <= 10 type with its default rule and no custom table
    goes to the fused stiffness kernel (ops.stiffness_kernels.
    stiffness_fused: the CUDA kernel on a CUDA tensor, its plain version
    on a CPU tensor), as tpufem routes it to its Pallas kernel on the TPU;
    everything else to the B^T D B pipeline.  fused=True forces the fused
    kernel (which raises for a (k, q) it is not built for; a custom table
    is then not used, as in tpufem), fused=False the B^T D B pipeline."""
    if fused is None:
        fused = (rule == "default" and table is None
                 and element_table(etype, rule).dN.shape[1] <= 10)
    if fused:
        from ..ops.stiffness_kernels import stiffness_fused
        return stiffness_fused(coords, conn, etype, E, nu, rule=rule,
                               dtype=dtype)
    return stiffness_bmat(coords, conn, etype, elasticity_matrix(E, nu),
                          rule=rule, table=table, dtype=dtype)


def stiffness_isotropic(coords, conn, etype: str, E: float, nu: float,
                        rule: str = "default",
                        table: Optional[ElementTable] = None,
                        dtype=None) -> torch.Tensor:
    """Element stiffness by the isotropic closed form (no B matrix):

        K[(k,c),(l,e)] = sum_q W_q [ lam g_k[c] g_l[e] + mu g_k[e] g_l[c]
                                     + mu (g_k . g_l) delta_ce ]

    as one contraction O = sum_q W g g^T plus blockwise transposes."""
    table = table or element_table(etype, rule)
    dtype = dtype or coords.dtype
    J = jacobians(coords, conn, table, dtype)
    g, detJ = shape_gradients_from_J(J, table, dtype)    # [M, q, k, 3]
    W = _const(table.weights, dtype, J.device)[None, :] * detJ
    M, q, k, _ = g.shape
    gf = g.reshape(M, q, 3 * k)
    O = torch.einsum("mqx,mqy->mxy", gf * W[:, :, None], gf)
    lam, mu = lame_parameters(E, nu)
    K = lam * O
    # mu * blockwise (3x3) transpose: out[(k,c),(l,e)] += mu O[(k,e),(l,c)]
    for c in range(3):
        for e in range(3):
            K[:, c::3, e::3] += mu * O[:, e::3, c::3]
    # mu * (g_k . g_l) on the component diagonal = mu * block-trace of O
    A = O[:, 0::3, 0::3] + O[:, 1::3, 1::3] + O[:, 2::3, 2::3]
    for c in range(3):
        K[:, c::3, c::3] += mu * A
    return K


def stiffness_per_ip(coords, conn, etype: str, E: float, nu: float,
                     rule: str = "default",
                     table: Optional[ElementTable] = None,
                     dtype=None) -> torch.Tensor:
    """Per-integration-point stiffness [q, M, 3k, 3k] = B^T D B detJ (the
    quadrature weight not applied)."""
    table = table or element_table(etype, rule)
    dtype = dtype or coords.dtype
    B, _, detJ = _packed_B_and_W(coords, conn, table, dtype)
    D = _const(elasticity_matrix(E, nu), dtype, B.device)
    DBd = torch.einsum("rs,mqsi,mq->mqri", D, B, detJ)
    return torch.einsum("mqri,mqrj->qmij", DBd, B)


def stiffness_bmat(coords, conn, etype: str, D, rule: str = "default",
                   table: Optional[ElementTable] = None,
                   dtype=None) -> torch.Tensor:
    """Element stiffness K[M, 3k, 3k] = sum_q w detJ B^T D B (any D[6,6])."""
    table = table or element_table(etype, rule)
    dtype = dtype or coords.dtype
    B, W, _ = _packed_B_and_W(coords, conn, table, dtype)
    D = _const(D, dtype, B.device)
    DBW = torch.einsum("rs,mqsi,mq->mqri", D, B, W)
    M, q, _, d = B.shape
    return torch.einsum("mxi,mxj->mij", DBW.reshape(M, 6 * q, d),
                        B.reshape(M, 6 * q, d))


# ---------------------------------------------------------------------------
# Mass
# ---------------------------------------------------------------------------

def mass(coords, conn, etype: str, rho: float, rule: str = "mass",
         table: Optional[ElementTable] = None, dtype=None) -> torch.Tensor:
    """Consistent element mass M[M, 3k, 3k] (C kron I3)."""
    table = table or element_table(etype, rule)
    dtype = dtype or coords.dtype
    J = jacobians(coords, conn, table, dtype)
    detJ = det3x3(J)
    w = _const(table.weights, dtype, J.device)
    N = _const(table.N, dtype, J.device)                          # [q, k]
    W = w[None, :] * detJ                                          # [M, q]
    C = rho * torch.einsum("mq,qi,qj->mij", W, N, N)               # [M, k, k]
    k = table.n_nodes
    Cr = torch.repeat_interleave(torch.repeat_interleave(C, 3, dim=1), 3,
                                 dim=2)                            # [M, 3k, 3k]
    eye_mask = _const(np.tile(np.eye(3, dtype=np.float64), (k, k)), dtype,
                      J.device)
    return Cr * eye_mask


def lumped_mass(coords, conn, etype: str, rho: float, rule: str = "mass",
                table: Optional[ElementTable] = None,
                dtype=None) -> torch.Tensor:
    """HRZ-lumped diagonal mass [M, 3k]: the consistent mass's diagonal
    scaled per element so the total equals rho * V."""
    table = table or element_table(etype, rule)
    dtype = dtype or coords.dtype
    J = jacobians(coords, conn, table, dtype)
    detJ = det3x3(J)
    w = _const(table.weights, dtype, J.device)
    N = _const(table.N, dtype, J.device)
    W = w[None, :] * detJ                                          # [M, q]
    diagC = rho * torch.einsum("mq,qi,qi->mi", W, N, N)            # [M, k]
    vol_mass = rho * torch.einsum("q,mq->m", w, detJ)              # [M]
    scale = vol_mass / diagC.sum(dim=1)
    d = diagC * scale[:, None]                                     # [M, k]
    return torch.repeat_interleave(d, 3, dim=1)                    # [M, 3k]


# ---------------------------------------------------------------------------
# Stress recovery
# ---------------------------------------------------------------------------

def element_stress(coords, conn, displacement, etype: str, E: float,
                   nu: float, rule: str = "default",
                   table: Optional[ElementTable] = None, single: bool = True,
                   dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stress tensors and von Mises per element.

    single=True  -> quadrature-weighted average, ([M,3,3], [M])
    single=False -> per integration point, ([M,q,3,3], [M,q])"""
    table = table or element_table(etype, rule)
    dtype = dtype or coords.dtype
    g, _ = shape_gradients(coords, conn, table, dtype)             # [M,q,k,3]
    ue = displacement[conn.long()].to(dtype)                       # [M,k,3]
    # grad_u[m,q,a,b] = d u_b / d x_a
    H = torch.einsum("mqka,mkb->mqab", g, ue)
    exx, eyy, ezz = H[..., 0, 0], H[..., 1, 1], H[..., 2, 2]
    gxy = H[..., 0, 1] + H[..., 1, 0]
    gyz = H[..., 1, 2] + H[..., 2, 1]
    gzx = H[..., 2, 0] + H[..., 0, 2]
    eps = torch.stack([exx, eyy, ezz, gxy, gyz, gzx], dim=-1)      # [M,q,6]
    D = _const(elasticity_matrix(E, nu), dtype, g.device)
    sig = torch.einsum("rs,mqs->mqr", D, eps)                      # [M,q,6]
    tens = stress_tensor(sig)                                      # [M,q,3,3]
    vm = von_mises(tens)                                           # [M,q]
    if not single:
        return tens, vm
    w = _const(table.weights, dtype, g.device)
    wsum = w.sum()
    tens_avg = torch.einsum("q,mqab->mab", w, tens) / wsum
    vm_avg = torch.einsum("q,mq->m", w, vm) / wsum
    return tens_avg, vm_avg


# ---------------------------------------------------------------------------
# Derived nodal quantities
# ---------------------------------------------------------------------------

def node_vm_stress(n_nodes: int, conn, element_vm: torch.Tensor,
                   dtype=None) -> torch.Tensor:
    """Mean of the element von Mises values at each node (0 where no
    element touches it).

    Deterministic: the (node, element) entries are sorted by node (a
    stable sort) and summed per node by a segment reduction, in element
    order; no atomics on the card."""
    dtype = dtype or element_vm.dtype
    conn = torch.as_tensor(conn, device=element_vm.device)
    k = conn.shape[1]
    idx = conn.reshape(-1).long()
    vals = torch.repeat_interleave(element_vm.to(dtype), k)
    srt, order = torch.sort(idx, stable=True)
    cnt = torch.bincount(srt, minlength=n_nodes)
    ssum = torch.segment_reduce(vals[order], "sum", lengths=cnt)
    cntf = cnt.to(dtype)
    return torch.where(cnt > 0, ssum / cntf.clamp(min=1), 0.0)
