"""Modal (generalized eigenvalue) solvers, K phi = lambda M phi (the port of
tpufem/solvers/modal.py).

* :func:`modal_solver`: inverse subspace iteration with Rayleigh-Ritz
  (its steps one by one: :func:`subspace_steps`).
  Y = K^-1 M X by an inner PCG per column, M-orthonormalization, the
  projected dense GEVP by Cholesky and eigh.  It converges to the
  SMALLEST modes.  tpufem vmaps its CG over the columns; here the columns
  are solved one after another through one solvers.cg.CGBlock (on the
  card its blocks are captured once and replayed for every column).
* :func:`naive_modal_solver`: tpufem's reference-parity forward iteration
  on M^-1 K (it amplifies the LARGEST modes, as tpufem warns).

The random start block comes from a torch.Generator on the mass's device
seeded with `seed`, so it is not tpufem's (jax.random) block: results
agree with tpufem's on converged eigenvalues and subspaces, not bitwise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.scatter import ScatterPlan
from .cg import CGBlock


def lumped_mass_diagonal(M_local: torch.Tensor, plan: ScatterPlan,
                         clamp: float = 1e-12) -> torch.Tensor:
    """[n_dof] lumped mass from consistent element mass matrices [M, d, d]
    (the diagonal of each, summed by the plan's deterministic scatter)."""
    d = torch.diagonal(M_local, dim1=1, dim2=2).contiguous()
    return torch.clamp(plan.scatter(d), min=clamp)


class ModalInfo(NamedTuple):
    iterations: int
    eigenvalue_history: np.ndarray


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _m_orthonormalize(X, Mdiag):
    """M-orthonormal basis via the Cholesky factor of X^T M X: X L^-T, the
    k x k inverse by a triangular solve against the identity (a
    triangular solve with the n_dof columns of X^T as right-hand sides
    takes seconds on the card at 4M DOF)."""
    G = X.T @ (Mdiag[:, None] * X)
    L = torch.linalg.cholesky(G)
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return X @ _solve_lower(L, eye).T


def _gevp(Ak, Bk):
    """(lam, Z) of the symmetric pencil (Ak, Bk) through Bk's Cholesky
    factor."""
    L = torch.linalg.cholesky(Bk)
    Linv_A = _solve_lower(L, Ak)
    C = _solve_lower(L, Linv_A.T).T
    lam, W = torch.linalg.eigh(0.5 * (C + C.T))
    return lam, torch.linalg.solve_triangular(L.T, W, upper=True)


def _rayleigh_ritz(Y, apply_K, Mdiag):
    return _gevp(Y.T @ apply_K(Y), Y.T @ (Mdiag[:, None] * Y))


def _free_mask(constraints, like: torch.Tensor) -> torch.Tensor:
    """The constraints' flat free mask ([n_dof] numpy for Constraints, a
    tensor for ops.packed.PackedConstraints) on like's device and dtype."""
    return torch.as_tensor(constraints.free_mask).reshape(-1).to(like)


def subspace_steps(operator: Callable, Mdiag: torch.Tensor,
                   n_dof_shape: Tuple[int, int], k: int, *,
                   constraints=None, inner_tol: float = 1e-8,
                   inner_max_iter: int = 400, seed: int = 0,
                   precondition=None):
    """modal_solver's iteration on k vectors, without end: yields
    (lam [k], X [n_dof, k]), first the M-orthonormal start block with
    lam = 0, then the Ritz pairs after each step."""
    N, nd = n_dof_shape
    n_dof = N * nd
    dtype, dev = Mdiag.dtype, Mdiag.device
    mask = (_free_mask(constraints, Mdiag) if constraints is not None
            else torch.ones_like(Mdiag))

    def apply_K_cols(X):
        return torch.stack([operator(X[:, j].reshape(N, nd).contiguous())
                            .reshape(-1)
                            for j in range(X.shape[1])], dim=1)

    block = CGBlock(operator, torch.zeros((N, nd), dtype=dtype, device=dev),
                    constraints=constraints, M_inv=precondition,
                    tol=inner_tol, record_history=False)

    def solve_K_cols(B):
        """Y = K^-1 B column by column (PCG with the projection)."""
        return torch.stack([
            block.solve(B[:, j].reshape(N, nd).contiguous(),
                        max_iter=inner_max_iter)[0].reshape(-1)
            for j in range(B.shape[1])], dim=1)

    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((n_dof, k), generator=gen, dtype=dtype, device=dev)
    X = _m_orthonormalize(X * mask[:, None], Mdiag)
    yield torch.zeros((k,), dtype=dtype, device=dev), X
    while True:
        Y = solve_K_cols(Mdiag[:, None] * X)       # inverse iteration step
        Y = _m_orthonormalize(Y * mask[:, None], Mdiag)
        lam, Z = _rayleigh_ritz(Y, apply_K_cols, Mdiag)
        X = Y @ Z
        yield lam, X


def modal_solver(operator: Callable, Mdiag: torch.Tensor,
                 n_dof_shape: Tuple[int, int], num_eigs: int = 5, *,
                 constraints=None, max_iter: int = 20,
                 inner_tol: float = 1e-8, inner_max_iter: int = 400,
                 seed: int = 0, precondition=None, n_guard: int = 2):
    """Smallest modes; returns (eigenvalues [k], modes [n_dof, k],
    ModalInfo).

    operator: u [N, nd] -> K u, SPD on the free DOFs; Mdiag: [N*nd] lumped
    mass diagonal (its device and dtype are the solve's); n_dof_shape:
    (N, nd); precondition: M_inv for the inner PCG; n_guard: extra
    subspace vectors, dropped from the result (the trailing Ritz values
    converge slowest)."""
    steps = subspace_steps(operator, Mdiag, n_dof_shape, num_eigs + n_guard,
                           constraints=constraints, inner_tol=inner_tol,
                           inner_max_iter=inner_max_iter, seed=seed,
                           precondition=precondition)
    lam, X = next(steps)
    history = []
    for _ in range(max_iter):
        lam, X = next(steps)
        history.append(lam[:num_eigs].cpu().numpy())
    return (lam[:num_eigs], X[:, :num_eigs],
            ModalInfo(max_iter, np.asarray(history)))


def naive_modal_solver(operator: Callable, Mdiag: torch.Tensor,
                       n_dof_shape: Tuple[int, int], num_eigs: int = 5, *,
                       fixed_dofs=None, max_iter: int = 20, seed: int = 0):
    """tpufem's reference-parity forward subspace iteration; returns
    (eigenvalues, modes)."""
    N, nd = n_dof_shape
    n_dof = N * nd
    k = num_eigs
    dtype, dev = Mdiag.dtype, Mdiag.device
    Minv = 1.0 / Mdiag
    mask = torch.ones((n_dof,), dtype=dtype, device=dev)
    if fixed_dofs is not None and np.size(fixed_dofs):
        mask[torch.as_tensor(np.asarray(fixed_dofs), device=dev).long()] = 0.0

    def apply_cols(X):
        return torch.stack([operator(X[:, j].reshape(N, nd).contiguous())
                            .reshape(-1)
                            for j in range(X.shape[1])], dim=1)

    def gram_schmidt(X):
        return torch.linalg.qr(X)[0]

    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((n_dof, k), generator=gen, dtype=dtype, device=dev)
    X = gram_schmidt(X * mask[:, None])
    for _ in range(max_iter):
        Y = apply_cols(X) * Minv[:, None]
        Y = gram_schmidt(Y * mask[:, None])
        lam, Z = _gevp(Y.T @ apply_cols(Y), Y.T @ (Mdiag[:, None] * Y))
        X = gram_schmidt((Y @ Z) * mask[:, None])
    lam, Z = _gevp(X.T @ apply_cols(X), X.T @ (Mdiag[:, None] * X))
    return lam, X @ Z
