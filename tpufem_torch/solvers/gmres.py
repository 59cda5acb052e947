"""Restarted GMRES with Givens rotations (the port of
tpufem/solvers/gmres.py).

One restart cycle of m inner steps is one block (``GMRESCycle``): tpufem's
scan runs all m steps whatever its ``done`` flag says, so the whole cycle
is a fixed sequence of device ops that a CUDA device captures once as a
CUDA graph and replays.  The Krylov basis V [(m+1), n] is allocated once
per cycle object.  Modified Gram-Schmidt stops at k = j: for k > j tpufem
subtracts 0 * V[k] (V[k] is still zero), which leaves w bitwise as it is.
The Hessenberg column, the rotations and g are device scalars within the
cycle; the m x m back-substitution is torch.linalg.solve_triangular.  The
host reads the status once per cycle and stops at the first cycle that
is not RUNNING; later cycles would change nothing (tpufem's scan leaves u,
the count and the status as they are and pads the history with inf).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .cg import (CONVERGED, MAX_ITER, RUNNING, GraphedBlock, SolveInfo,
                 _noop)
from .cg import dot as _vdot


class GMRESCycle(GraphedBlock):
    """One restart cycle on device buffers: u (shaped like b), the
    right-hand side b, V [(m+1), n], status and used (int32 scalars) and
    res [m], the cycle's residual estimates |g[j+1]| (inf past the
    iterations it used).  `run(m)` runs the cycle (a CUDA graph on the
    card); `solve` holds the cycles and the final residual."""

    kind = "gmres"

    def __init__(self, A: Callable, like: torch.Tensor, *, constraints=None,
                 M_inv=None, tol: float = 1e-8, restart: int = 50,
                 eps: float = 1e-30):
        super().__init__(like.device)
        if M_inv is not None:
            A_raw = A
            A = lambda u: A_raw(u) * M_inv  # noqa: E731
        self.A, self.M_inv = A, M_inv
        self.constraints = constraints
        self.tol, self.eps, self.m = float(tol), float(eps), int(restart)
        self.dtype, self.shape = like.dtype, tuple(like.shape)
        self.project = constraints.project_residual if constraints else _noop
        self.set_state = constraints.apply_state if constraints else _noop
        self.project(like)               # device tables exist before capture
        self.set_state(like)
        dev = like.device
        self.u = torch.empty_like(like)
        self.b = torch.empty_like(like)
        self.V = torch.zeros((self.m + 1, like.numel()), dtype=like.dtype,
                             device=dev)
        self.status = torch.empty((), dtype=torch.int32, device=dev)
        self.used = torch.empty((), dtype=torch.int32, device=dev)
        self.res = torch.empty((self.m,), dtype=like.dtype, device=dev)
        self.eye_eps = torch.eye(self.m, dtype=like.dtype, device=dev) * eps
        self.pos = torch.arange(self.m, device=dev)

    def body(self, n: int) -> None:
        """One cycle (n is the restart length m)."""
        A, project, set_state = self.A, self.project, self.set_state
        eps, m, shape, V = self.eps, self.m, self.shape, self.V
        zero = torch.zeros((), dtype=self.dtype, device=V.device)
        was_running = self.status == RUNNING
        r = project(self.b - A(self.u)).reshape(-1)
        beta = torch.sqrt(_vdot(r, r))
        V[0].copy_(r / (beta + eps))
        cs, sn, cols, res = [], [], [], []
        g = [beta] + [zero] * m
        for j in range(m):
            w = project(A(V[j].reshape(shape))).reshape(-1)
            h = [zero] * (m + 1)
            for k in range(j + 1):             # modified Gram-Schmidt
                hk = _vdot(V[k], w)
                w = w - hk * V[k]
                h[k] = hk
            hj1 = torch.sqrt(_vdot(w, w))
            h[j + 1] = hj1
            V[j + 1].copy_(w / (hj1 + eps))
            for k in range(j):                 # the earlier rotations
                t = cs[k] * h[k] + sn[k] * h[k + 1]
                h2 = -sn[k] * h[k] + cs[k] * h[k + 1]
                h[k], h[k + 1] = t, h2
            denom = torch.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c = h[j] / (denom + eps)
            s = h[j + 1] / (denom + eps)
            h[j], h[j + 1] = denom, zero
            cs.append(c)
            sn.append(s)
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            cols.append(torch.stack(h[:m]))
            res.append(torch.abs(g[j + 1]))
        # back-substitution on the m x m triangular system
        Hm = torch.stack(cols, dim=1) + self.eye_eps
        y = torch.linalg.solve_triangular(Hm, torch.stack(g[:m])[:, None],
                                          upper=True)[:, 0]
        u_new = set_state(self.u + (y @ V[:m]).reshape(shape))
        res = torch.stack(res)
        reached = res < self.tol
        hit = reached.any()
        iters = torch.where(hit, torch.argmax(reached.to(torch.int32)) + 1,
                            m)
        self.used.copy_(self.used + torch.where(was_running, iters, 0))
        self.status.copy_(torch.where(was_running & hit, CONVERGED,
                                      self.status))
        self.res.copy_(torch.where(was_running & (self.pos < iters), res,
                                   float("inf")))
        self.u.copy_(torch.where(was_running, u_new, self.u))

    def solve(self, b: torch.Tensor, *, x0: Optional[torch.Tensor] = None,
              max_iter: int = 1000):
        """Solve A u = b; (u, SolveInfo).  tol is absolute on the (left-
        preconditioned, with M_inv) residual; the history holds every
        cycle's m estimates, inf past the iterations used."""
        if tuple(b.shape) != self.shape or b.dtype != self.dtype:
            raise ValueError(
                f"b {tuple(b.shape)} {b.dtype} does not match the cycle's "
                f"state {self.shape} {self.dtype}")
        m = self.m
        bb = b * self.M_inv if self.M_inv is not None else b
        self.b.copy_(bb)
        self.u.copy_(self.set_state(torch.zeros_like(b) if x0 is None
                                    else x0.to(b.dtype)))
        self.status.fill_(RUNNING)
        self.used.zero_()
        n_cycles = max(1, -(-max_iter // m))
        hist = torch.full((n_cycles * m,), float("inf"), dtype=b.dtype,
                          device=b.device)
        for c in range(n_cycles):
            if not self.advance(m):
                break
            hist[c * m:(c + 1) * m] = self.res
        u = self.u.clone()
        r = self.project(self.b - self.A(u))
        rnorm = torch.sqrt(_vdot(r, r))
        status = torch.where(
            self.status == RUNNING,
            torch.where(rnorm < self.tol, CONVERGED, MAX_ITER),
            self.status).to(torch.int32)
        return u, SolveInfo(status, self.used.clone(), rnorm, hist)


def gmres(A: Callable, b: torch.Tensor, *, constraints=None, M_inv=None,
          x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
          max_iter: int = 1000, restart: int = 50, eps: float = 1e-30):
    """Solve A u = b; (u, SolveInfo).  tol is absolute on ||r||.

    M_inv: optional Jacobi (diagonal) preconditioner broadcastable to b,
    applied on the left (tpufem's): the recursion runs on M^-1 A u =
    M^-1 b, so tol, the history and the returned residual_norm are on
    ||M^-1 r||.  One GMRESCycle serves the call; a caller that solves
    many times keeps the cycle (its V and its graph) and calls `solve`."""
    cycle = GMRESCycle(A, b, constraints=constraints, M_inv=M_inv, tol=tol,
                       restart=restart, eps=eps)
    return cycle.solve(b, x0=x0, max_iter=max_iter)
