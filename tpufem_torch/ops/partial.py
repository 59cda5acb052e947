"""Partial-assembly (geometry-factor) matrix-free operator.

The port of tpufem/ops/partial.py.  The operator stores only the
quadrature geometry (J^-1 and w * detJ; a single J^-1 per element when the
element is affine) and recomputes the stiffness action of an isotropic
material at every apply:

    eps  = sym(J^-T dNhat^T u_e)            per ip   (ref-coord gradients)
    sig  = lam tr(eps) I + 2 mu eps
    F_e += w detJ dNhat J^-1 sig                     (B^T sig without B)

then sums the element forces onto the nodes through a ScatterPlan (fixed
order, no atomics).  tpufem runs the element math as XLA einsums outside
any kernel; here they are torch einsums, which run in full float32 with
TF32 off.  ``pa_apply_components`` is tpufem's component-unrolled form of
the same action (elementwise [M]-vector chains), which the clustered
partial operator runs.  ``chunked_geometry`` streams the geometry build
through element chunks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.materials import lame_parameters
from ..elements.solid import det3x3, inv3x3, jacobians
from ..elements.tables import ElementTable, element_table
from .scatter import ScatterPlan


def pa_apply_components(ue_cols, Jinv_cols, W, dN, lam, mu):
    """Component-unrolled partial-assembly action.

    Args:
      ue_cols: tuple of 3 tensors [M, k]: element nodal values per component.
      Jinv_cols: [M, qJ, 9] with qJ in {1, q}: J^-1 entries (row-major).
      W: [M, q]: w * detJ.
      dN: numpy [q, k, 3] reference gradients (constants; zero weights are
        skipped, as in tpufem).
    Returns:
      tuple of 3 tensors [M, k]: element nodal forces per component.
    """
    q = W.shape[1]
    k = ue_cols[0].shape[1]
    qJ = Jinv_cols.shape[1]
    dN = np.asarray(dN)
    Fe = [[None] * k for _ in range(3)]
    for qi in range(q):
        Ji = [[Jinv_cols[:, min(qi, qJ - 1), 3 * i + j] for j in range(3)]
              for i in range(3)]
        # Hhat[a][c] = sum_k dN[qi, k, a] ue_c[:, k]
        Hhat = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for c in range(3):
                acc = None
                for kk in range(k):
                    w = float(dN[qi, kk, a])
                    if w == 0.0:
                        continue
                    term = w * ue_cols[c][:, kk]
                    acc = term if acc is None else acc + term
                Hhat[a][c] = acc if acc is not None else 0.0
        # H[i][c] = sum_j Jinv[i][j] Hhat[j][c]
        H = [[sum(Ji[i][j] * Hhat[j][c] for j in range(3)) for c in range(3)]
             for i in range(3)]
        # sig = lam tr(eps) I + 2 mu eps, eps = sym(H)
        tr = H[0][0] + H[1][1] + H[2][2]
        sig = [[mu * (H[i][c] + H[c][i]) for c in range(3)] for i in range(3)]
        for i in range(3):
            sig[i][i] = sig[i][i] + lam * tr
        # T[j][c] = W * sum_i Jinv[i][j] sig[i][c]
        Wq = W[:, qi]
        T = [[Wq * sum(Ji[i][j] * sig[i][c] for i in range(3))
              for c in range(3)] for j in range(3)]
        # Fe_c[:, kk] += sum_j dN[qi, kk, j] T[j][c]
        for c in range(3):
            for kk in range(k):
                acc = None
                for j in range(3):
                    w = float(dN[qi, kk, j])
                    if w == 0.0:
                        continue
                    term = w * T[j][c]
                    acc = term if acc is None else acc + term
                if acc is None:
                    continue
                prev = Fe[c][kk]
                Fe[c][kk] = acc if prev is None else prev + acc
    zero = torch.zeros_like(W[:, 0])
    return tuple(
        torch.stack([Fe[c][kk] if Fe[c][kk] is not None else zero
                     for kk in range(k)], dim=1)
        for c in range(3))


class PartialAssemblyOperator(torch.nn.Module):
    """u [N, 3] -> F [N, 3], geometry-factor form (isotropic material).

    Buffers: Jinv [M, q, 3, 3] (or [M, 1, 3, 3] when affine), W [M, q]
    (w * detJ), conn [M, k] and dN [q, k, 3], on the plan's device."""

    def __init__(self, Jinv: torch.Tensor, W: torch.Tensor,
                 conn: torch.Tensor, dN: torch.Tensor, plan: ScatterPlan,
                 lam: float, mu: float, affine: bool):
        super().__init__()
        for name, t in (("Jinv", Jinv), ("W", W), ("conn", conn),
                        ("dN", dN)):
            self.register_buffer(name, t)
        self.plan = plan
        self.lam_mu = (float(lam), float(mu))
        self.affine = bool(affine)

    @staticmethod
    def build(coords, conn, etype: str, E: float, nu: float,
              rule: str = "default", plan: Optional[ScatterPlan] = None,
              affine: Optional[bool] = None, dtype=None,
              table: Optional[ElementTable] = None,
              n_nodes: Optional[int] = None, device=None
              ) -> "PartialAssemblyOperator":
        """Geometry from coords (numpy or a tensor) and conn [M, k]; the
        plan is built from conn when None, on `device` (None: the plan's
        device, else the CUDA card).  affine=None detects it (J constant
        across the ips within 1e-4 relative)."""
        table = table or element_table(etype, rule)
        dev = plan.device if plan is not None else resolve_device(device)
        coords_t = torch.as_tensor(
            coords if isinstance(coords, torch.Tensor)
            else np.asarray(coords), device=dev)
        dtype = dtype or coords_t.dtype
        coords_t = coords_t.to(dtype)
        conn_np = (conn.cpu().numpy() if isinstance(conn, torch.Tensor)
                   else np.asarray(conn))
        conn_t = torch.as_tensor(conn_np, device=dev)
        if plan is None:
            if n_nodes is None:
                raise ValueError(
                    "PartialAssemblyOperator.build needs the true node "
                    "count: pass n_nodes= (conn.max()+1 silently drops "
                    "trailing unreferenced nodes) or a prebuilt plan=")
            plan = ScatterPlan.build(conn_np, int(n_nodes), 3, device=dev)
        Jinv, W, is_affine = chunked_geometry(coords_t, conn_t, table, dtype)
        if affine is None:
            affine = is_affine
        if affine:
            Jinv = Jinv[:, :1].contiguous()
        lam, mu = lame_parameters(E, nu)
        return PartialAssemblyOperator(
            Jinv, W, conn_t, torch.as_tensor(table.dN, dtype=dtype,
                                             device=dev),
            plan, lam, mu, affine)

    def Jinv_b(self) -> torch.Tensor:
        """Jinv broadcast to [M, q, 3, 3] (affine stores a single slice)."""
        if self.affine and self.Jinv.shape[1] == 1:
            return self.Jinv.expand(self.Jinv.shape[0], self.W.shape[1], 3, 3)
        return self.Jinv

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        lam, mu = self.lam_mu
        ue = u[self.conn.long()]                                # [M, k, 3]
        # reference-coordinate displacement gradient per ip
        Hhat = torch.einsum("qka,mkb->mqab", self.dN, ue)       # [M, q, 3, 3]
        Jb = self.Jinv_b()
        # physical gradient H[i, b] = sum_j Jinv[i, j] Hhat[j, b]
        H = torch.einsum("mqij,mqjb->mqib", Jb, Hhat)
        eps = 0.5 * (H + H.transpose(-1, -2))
        tr = eps[..., 0, 0] + eps[..., 1, 1] + eps[..., 2, 2]
        sig = 2.0 * mu * eps
        sig = sig + (lam * tr)[..., None, None] * torch.eye(
            3, dtype=u.dtype, device=u.device)
        # T[j, b] = w detJ sum_i Jinv[i, j] sig[i, b]
        T = torch.einsum("mq,mqij,mqib->mqjb", self.W, Jb, sig)
        Fe = torch.einsum("qkj,mqjb->mkb", self.dN, T)          # [M, k, 3]
        return self.plan.scatter(Fe.reshape(Fe.shape[0], -1)).reshape(u.shape)

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal [n_dof]:
        sum_q W ((lam + mu) g_ia^2 + mu |g_i|^2)."""
        lam, mu = self.lam_mu
        g = torch.einsum("mqij,qkj->mqki", self.Jinv_b(), self.dN)  # [M,q,k,3]
        g2 = torch.einsum("mq,mqka,mqka->mka", self.W, g, g)
        norm2 = torch.sum(g2, dim=-1, keepdim=True)                 # [M,k,1]
        d = (lam + mu) * g2 + mu * norm2                            # [M,k,3]
        return self.plan.scatter(d.reshape(d.shape[0], -1))


def chunked_geometry(coords: torch.Tensor, conn_sel: torch.Tensor,
                     table: ElementTable, dtype, chunk: int = 1 << 21):
    """(Jinv [M, q, 3, 3], W [M, q], affine) computed in element chunks.

    `affine` is True when J varies by less than 1e-4 (relative) across the
    quadrature points of every element, as on straight-edged tets: the
    caller then keeps one J^-1 per element (qJ = 1)."""
    M = conn_sel.shape[0]
    wts = torch.as_tensor(table.weights, dtype=dtype, device=coords.device)
    parts_J, parts_W, spreads = [], [], []
    for a in range(0, max(M, 1), chunk):
        J = jacobians(coords, conn_sel[a:a + chunk], table, dtype)
        detJ = det3x3(J)
        spreads.append(torch.max(torch.abs(J - J[:, :1]))
                       / (torch.max(torch.abs(J)) + 1e-30))
        parts_J.append(inv3x3(J, detJ))
        parts_W.append(wts[None, :] * detJ)
    spread = float(torch.stack(spreads).max())
    return torch.cat(parts_J), torch.cat(parts_W), spread < 1e-4
