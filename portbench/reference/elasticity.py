"""Plain reference for the benchmark's solves: linear isotropic elasticity
in float64, written from the equations, on the element that a
configuration names (its shape functions and quadrature rule from
``portbench.reference.elements``).

    K u = sum_e sum_q W_q G_e^T sigma(G_e u_e)
    G   = J^-1 dN      (physical shape-function gradients at point q)
    H   = G^T u_e      (H[a, b] = du_b / dx_a)
    sigma = lam tr(H) I + mu (H + H^T),   W_q = w_q det J

The geometry is worked out again from the coordinates at every apply, the
scatter adds element forces to nodes with index_add_, and the element loop
runs in chunks so that a million elements fit beside nothing else.
Imports torch and numpy only: nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from . import elements

F64 = torch.float64


def lame(E: float, nu: float):
    return E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))


def _inverse3(J: torch.Tensor):
    """(J^-1, det J) of [..., 3, 3] by the adjugate."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A, B, C = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e], -1),
        torch.stack([B, a * i - c * g, c * d - a * f], -1),
        torch.stack([C, b * g - a * h, a * e - b * d], -1)], -2)
    return adj / det[..., None, None], det


class Elasticity:
    """The reference operator u [N, 3] -> K u [N, 3] and diag(K) [N, 3],
    float64 on `device`, from the mesh arrays, the element type (a module
    of portbench.reference.elements) and the material."""

    def __init__(self, coords, conn, etype: str, E: float, nu: float,
                 device="cpu", chunk: int = 1 << 18):
        dev = torch.device(device)
        el = elements.load(etype)
        dN = el.gradients(el.POINTS)
        self.X = torch.as_tensor(np.asarray(coords), dtype=F64, device=dev)
        self.conn = torch.as_tensor(np.asarray(conn), device=dev).long()
        self.N = self.X.shape[0]
        self.dN = torch.as_tensor(dN, dtype=F64, device=dev)
        self.w = torch.as_tensor(el.WEIGHTS, dtype=F64, device=dev)
        self.lam, self.mu = lame(float(E), float(nu))
        self.chunk = int(chunk)

    def _gradients(self, cc: torch.Tensor):
        """(G [m, q, k, 3] physical gradients, W [m, q]) of a chunk."""
        Xe = self.X[cc]                                      # [m, k, 3]
        J = torch.einsum("qka,mkb->mqab", self.dN, Xe)        # dx_b/dxi_a
        Jinv, det = _inverse3(J)
        G = torch.einsum("mqab,qkb->mqka", Jinv, self.dN)
        return G, self.w * det

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        u = u.to(F64).reshape(self.N, 3)
        F = torch.zeros_like(u)
        eye = torch.eye(3, dtype=F64, device=u.device)
        for c0 in range(0, self.conn.shape[0], self.chunk):
            cc = self.conn[c0:c0 + self.chunk]
            G, W = self._gradients(cc)
            H = torch.einsum("mqka,mkb->mqab", G, u[cc])
            tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
            sig = (self.lam * tr)[..., None, None] * eye \
                + self.mu * (H + H.transpose(-1, -2))
            fe = torch.einsum("mq,mqka,mqab->mkb", W, G, sig)
            F.index_add_(0, cc.reshape(-1), fe.reshape(-1, 3))
        return F

    def diagonal(self) -> torch.Tensor:
        """diag(K) [N, 3]: sum_q W (lam G_kb^2 + mu (|G_k|^2 + G_kb^2))."""
        D = torch.zeros((self.N, 3), dtype=F64, device=self.X.device)
        for c0 in range(0, self.conn.shape[0], self.chunk):
            cc = self.conn[c0:c0 + self.chunk]
            G, W = self._gradients(cc)
            G2 = G * G
            de = torch.einsum("mq,mqkb->mkb", W, (self.lam + self.mu) * G2
                              + self.mu * G2.sum(-1, keepdim=True))
            D.index_add_(0, cc.reshape(-1), de.reshape(-1, 3))
        return D


def free_mask(n_nodes: int, fixed, device="cpu") -> torch.Tensor:
    """[N, 3] float64: 0 on the fixed nodes, 1 elsewhere."""
    m = torch.ones((n_nodes, 3), dtype=F64, device=device)
    m[torch.as_tensor(np.asarray(fixed), device=device).long()] = 0.0
    return m


def relative_residual(op: Elasticity, u, b, free: torch.Tensor) -> float:
    """||P (b - K u)|| / ||P b|| with P the free-DOF projection."""
    b = torch.as_tensor(np.asarray(b), dtype=F64, device=free.device)
    u = torch.as_tensor(np.asarray(u), dtype=F64, device=free.device)
    r = (b - op.apply(u)) * free
    return float(torch.linalg.norm(r) / torch.linalg.norm(b * free))


def jacobi_pcg(op: Elasticity, b, free: torch.Tensor, tol_rel: float,
               max_iter: int):
    """Plain Jacobi-preconditioned CG on the free DOFs in float64.
    Returns (u [N, 3], iterations, converged)."""
    b = torch.as_tensor(np.asarray(b), dtype=F64, device=free.device) * free
    minv = torch.where(free > 0, 1.0 / op.diagonal(), 0.0)
    u = torch.zeros_like(b)
    r = b.clone()
    z = minv * r
    p = z.clone()
    rz = torch.sum(r * z)
    stop = tol_rel * float(torch.linalg.norm(b))
    it = 0
    while it < max_iter and float(torch.linalg.norm(r)) > stop:
        Ap = op.apply(p) * free
        alpha = rz / torch.sum(p * Ap)
        u = u + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz, rz_old = torch.sum(r * z), rz
        p = z + (rz / rz_old) * p
        it += 1
    return u, it, float(torch.linalg.norm(r)) <= stop
