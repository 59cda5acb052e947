"""BiCGStab with tpufem's status semantics (the port of
tpufem/solvers/bicgstab.py).

tpufem runs the loop as one ``lax.while_loop``.  Here it runs in blocks of
``CHECK_EVERY`` iterations (``BiCGStabBlock``) whose state stays on the
device, as cg's ``CGBlock`` does: a device-side ``running`` flag freezes
the state and the count once the status leaves RUNNING, the host reads the
status only between blocks, and on a CUDA device each block length is
captured once as a CUDA graph and replayed.  tol is RELATIVE to ||r0||
(tpufem's); there is no preconditioner (tpufem has none).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .cg import (CHECK_EVERY, CONVERGED, MAX_ITER, NAN_INF, NOT_SPD, RUNNING,
                 GraphedBlock, SolveInfo, _noop)
from .cg import dot as _vdot

BREAKDOWN = NOT_SPD  # rho == 0 maps onto the "invalid operator" code


class BiCGStabBlock(GraphedBlock):
    """BiCGStab's loop body on device buffers: u, r, p, v (shaped like b),
    r_hat (the shadow residual), rho, alpha, omega, tol2, hlast (device
    scalars), status and i (int32), hblock [CHECK_EVERY].  `run(n)`
    advances n <= CHECK_EVERY iterations (a CUDA graph per n on the card);
    `solve` holds the prologue and the block loop."""

    kind = "bicgstab"

    def __init__(self, A: Callable, like: torch.Tensor, *, constraints=None,
                 tol: float = 1e-8, eps: float = 1e-30):
        super().__init__(like.device)
        self.A = A
        self.constraints = constraints
        self.tol, self.eps = float(tol), float(eps)
        self.dtype = like.dtype
        self.project = constraints.project_residual if constraints else _noop
        self.set_state = constraints.apply_state if constraints else _noop
        self.project(like)               # device tables exist before capture
        self.set_state(like)
        vec = lambda: torch.empty_like(like)  # noqa: E731
        scal = lambda dt=like.dtype: torch.empty(  # noqa: E731
            (), dtype=dt, device=like.device)
        self.u, self.r, self.p, self.v, self.r_hat = (vec() for _ in range(5))
        self.rho, self.alpha, self.omega, self.tol2, self.hlast = (
            scal() for _ in range(5))
        self.status = scal(torch.int32)
        self.i = scal(torch.int32)
        self.hblock = torch.empty((CHECK_EVERY,), dtype=like.dtype,
                                  device=like.device)

    def body(self, n: int) -> None:
        A, project, set_state, eps = self.A, self.project, self.set_state, \
            self.eps
        r_hat, tol2 = self.r_hat, self.tol2
        u, r, p, v = self.u, self.r, self.p, self.v
        rho, alpha, omega = self.rho, self.alpha, self.omega
        hlast, status, i = self.hlast, self.status, self.i
        for j in range(n):
            running = status == RUNNING
            rho_new = _vdot(r_hat, r)
            breakdown = rho_new == 0.0
            beta = (rho_new / (rho + eps)) * (alpha / (omega + eps))
            p1 = project(torch.where(i == 0, r, r + beta * (p - omega * v)))
            v1 = A(p1)
            alpha1 = rho_new / (_vdot(r_hat, v1) + eps)
            sres = r - alpha1 * v1
            t = A(project(sres))
            omega1 = _vdot(t, sres) / (_vdot(t, t) + eps)
            u1 = set_state(u + alpha1 * p1 + omega1 * sres)
            r1 = project(sres - omega1 * t)
            rs = _vdot(r1, r1)
            bad = torch.isnan(rs) | torch.isinf(rs)
            new_status = torch.where(
                breakdown, BREAKDOWN,
                torch.where(bad, NAN_INF,
                            torch.where(rs < tol2, CONVERGED, RUNNING))
            ).to(torch.int32)
            take = ~breakdown & ~bad
            keep = running & take
            u = torch.where(keep, u1, u)
            r = torch.where(keep, r1, r)
            p = torch.where(running, p1, p)
            v = torch.where(running, v1, v)
            rho = torch.where(running, rho_new, rho)
            alpha = torch.where(running, alpha1, alpha)
            omega = torch.where(running, omega1, omega)
            hlast = torch.where(running, torch.where(take, torch.sqrt(rs),
                                                     hlast), float("inf"))
            self.hblock[j] = hlast
            status = torch.where(running, new_status, status)
            i = i + running.to(torch.int32)
        for name, val in (("u", u), ("r", r), ("p", p), ("v", v),
                          ("rho", rho), ("alpha", alpha), ("omega", omega),
                          ("hlast", hlast), ("status", status), ("i", i)):
            buf = getattr(self, name)
            if val is not buf:
                buf.copy_(val)

    def solve(self, b: torch.Tensor, *, x0: Optional[torch.Tensor] = None,
              max_iter: int = 1000):
        """Solve A u = b; (u, SolveInfo) with tpufem's history: [max_iter
        + 1] ||r|| per iteration, inf past the last."""
        if b.shape != self.u.shape or b.dtype != self.dtype:
            raise ValueError(
                f"b {tuple(b.shape)} {b.dtype} does not match the block's "
                f"state {tuple(self.u.shape)} {self.dtype}")
        dtype, dev = b.dtype, b.device
        u = self.set_state(torch.zeros_like(b) if x0 is None
                           else x0.to(dtype))
        r = self.project(b - self.A(u))
        rs0 = _vdot(r, r)
        tol2 = (self.tol ** 2) * rs0
        hist = torch.full((max_iter + 1,), float("inf"), dtype=dtype,
                          device=dev)
        hist[0] = torch.sqrt(rs0)
        for name, val in (("u", u), ("r", r), ("r_hat", r), ("tol2", tol2),
                          ("hlast", hist[0])):
            getattr(self, name).copy_(val)
        self.p.zero_()
        self.v.zero_()
        for name in ("rho", "alpha", "omega"):
            getattr(self, name).fill_(1.0)
        self.status.copy_(torch.where(rs0 < tol2, CONVERGED, RUNNING))
        self.i.zero_()
        for it in range(0, max_iter, CHECK_EVERY):
            n = min(CHECK_EVERY, max_iter - it)
            if not self.advance(n):
                break
            hist[it + 1:it + 1 + n] = self.hblock[:n]
        status = torch.where(self.status == RUNNING, MAX_ITER,
                             self.status).to(torch.int32)
        u = self.u.clone()
        rnorm = torch.sqrt(_vdot(self.r, self.r))
        return u, SolveInfo(status, self.i.clone(), rnorm, hist)


def bicgstab(A: Callable, b: torch.Tensor, *, constraints=None,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
             max_iter: int = 1000, eps: float = 1e-30):
    """Solve A u = b; returns (u, SolveInfo).  tol is RELATIVE to ||r0||
    (tpufem's bicgstab).  One BiCGStabBlock serves the call; a caller that
    solves many times keeps the block and calls its `solve`."""
    block = BiCGStabBlock(A, b, constraints=constraints, tol=tol, eps=eps)
    return block.solve(b, x0=x0, max_iter=max_iter)
