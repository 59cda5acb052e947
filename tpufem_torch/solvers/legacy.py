"""Reference-signature solver entry points (the port of
tpufem/solvers/legacy.py).

Each function keeps a reference signature (the original solver.py) so code
written against it maps 1:1; each routes to the port's solvers.  The
`device=` argument follows the port's rule (None means the CUDA card,
"cpu" the plain PyTorch path); the `dtype=` defaults are tpufem's (numpy
or torch dtypes are taken).  Results are tensors on that device.

    stable_conjugate_gradient_solver, final_solver,
    stable_conjugate_gradient_shell_solver,
    constrained_conjugate_gradient_solver,
    new_constrained_conjugate_gradient_solver,
    preconditioned_conjugate_gradient_solver,
    compute_diagonal_preconditioner, bicgstab_solver, gmres_solver,
    newton_raphson_solver, vectorized_modal_solver,
    parse_spc_list, parse_rbe2_list, parse_rbe3_list, apply_loads_to_F
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..elements.shell import ShellOperator, local_frames
from ..ops.operator import MatrixFreeOperator
from ..ops.scatter import ScatterPlan
from . import modal as modal_mod
from .bicgstab import bicgstab
from .cg import cg, masked_cg
from .constraints import Constraints
from .gmres import gmres
from .newton import newton_raphson


def _dt(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _np_dt(dtype) -> np.dtype:
    return torch.empty((), dtype=_dt(dtype)).numpy().dtype


def _tensor(x, dtype, dev) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    return t.to(device=dev, dtype=_dt(dtype))


def _opt(x, dtype, dev):
    return None if x is None else _tensor(x, dtype, dev)


def _conn(elements) -> np.ndarray:
    if isinstance(elements, torch.Tensor):
        return elements.cpu().numpy()
    return np.asarray(elements)


def _op(K, elements, n_nodes: int, nd: int, dev) -> MatrixFreeOperator:
    plan = ScatterPlan.build(_conn(elements), n_nodes, nd, device=dev)
    return MatrixFreeOperator(K, plan)


def _fixed_cons(n_nodes, fixed, nd, dtype):
    fixed = fixed.cpu().numpy() if isinstance(fixed, torch.Tensor) else fixed
    return Constraints.fixed(n_nodes, np.asarray(fixed), nd,
                             dtype=_np_dt(dtype))


def stable_conjugate_gradient_solver(K, elements, F, rbe2, u_init=None,
                                     tol=1e-10, max_iter=1000, device=None,
                                     dtype=np.float64, eps=1e-30):
    dev = resolve_device(device)
    F = _tensor(F, dtype, dev)
    N = F.shape[0]
    op = _op(_tensor(K, dtype, dev), elements, N, 3, dev)
    u, _ = cg(op, F, constraints=_fixed_cons(N, rbe2, 3, dtype),
              x0=_opt(u_init, dtype, dev), tol=tol, max_iter=max_iter,
              eps=eps)
    return u


def final_solver(K, elements, F, rbe2, u_init=None, tol=1e-10, max_iter=1000,
                 device=None, dtype=np.float64, eps=1e-30):
    """Mask-based (autograd-friendly) CG variant."""
    dev = resolve_device(device)
    F = _tensor(F, dtype, dev)
    N = F.shape[0]
    op = _op(_tensor(K, dtype, dev), elements, N, 3, dev)
    mask = np.ones((N, 3), _np_dt(dtype))
    mask[np.asarray(rbe2)] = 0.0
    u, _ = masked_cg(op, F, torch.as_tensor(mask, device=dev),
                     x0=_opt(u_init, dtype, dev), tol=tol, max_iter=max_iter,
                     eps=eps)
    return u


def stable_conjugate_gradient_shell_solver(K, elements, F, rbe2, coords=None,
                                           unit=None, u_init=None, tol=1e-10,
                                           max_iter=1000, device=None,
                                           dtype=np.float64, eps=1e-30):
    dev = resolve_device(device)
    F = _tensor(F, dtype, dev)
    N = F.shape[0]
    if unit is None:
        if coords is None:
            raise ValueError("Neither coords nor unit frames were provided")
        unit = local_frames(_tensor(coords, dtype, dev),
                            torch.as_tensor(_conn(elements), device=dev))
    plan = ScatterPlan.build(_conn(elements), N, 6, device=dev)
    op = ShellOperator(_tensor(K, dtype, dev), _tensor(unit, dtype, dev),
                       plan)
    u, _ = cg(op, F, constraints=_fixed_cons(N, rbe2, 6, dtype),
              x0=_opt(u_init, dtype, dev), tol=tol, max_iter=max_iter,
              eps=eps)
    return u


def parse_spc_list(spc_list, device=None, dtype=np.float64):
    """Flat (nodes, dofs, values) tensors."""
    dev = resolve_device(device)
    nodes, dofs, vals = [], [], []
    for spc in spc_list:
        for d in spc["dofs"]:
            nodes.append(spc["node"])
            dofs.append(d)
            vals.append(spc["value"])
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.tensor(nodes, **i32), torch.tensor(dofs, **i32),
            _tensor(np.asarray(vals, _np_dt(dtype)), dtype, dev))


def parse_rbe2_list(rbe2_list, device=None):
    """Flat (slaves, masters, dofs) tensors."""
    dev = resolve_device(device)
    slaves, masters, dofs = [], [], []
    for r in rbe2_list:
        for s in r["slaves"]:
            for d in r["dofs"]:
                slaves.append(s)
                masters.append(r["master"])
                dofs.append(d)
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.tensor(slaves, **i32), torch.tensor(masters, **i32),
            torch.tensor(dofs, **i32))


def parse_rbe3_list(rbe3_list, device=None, dtype=np.float64):
    """Flat (masters, slaves, dofs, weights, offsets, weight sums)."""
    dev = resolve_device(device)
    m_l, s_l, d_l, w_l, sums, offs = [], [], [], [], [], [0]
    run = 0
    for r in rbe3_list:
        for i, s in enumerate(r["slaves"]):
            for d in r["dofs"]:
                m_l.append(r["master"])
                s_l.append(s)
                d_l.append(d)
                w_l.append(r["weights"][i])
        run += len(r["slaves"]) * len(r["dofs"])
        sums.append(sum(r["weights"]))
        offs.append(run)
    i32 = dict(dtype=torch.int32, device=dev)
    npdt = _np_dt(dtype)
    return (torch.tensor(m_l, **i32), torch.tensor(s_l, **i32),
            torch.tensor(d_l, **i32),
            _tensor(np.asarray(w_l, npdt), dtype, dev),
            torch.tensor(offs, dtype=torch.int64, device=dev),
            _tensor(np.asarray(sums, npdt), dtype, dev))


def apply_loads_to_F(F, load_list):
    """Accumulate {'node', 'force': [fx, fy, fz]} dicts into a copy of F
    [N, >= 3] (host numpy)."""
    F = (F.cpu().numpy() if isinstance(F, torch.Tensor)
         else np.asarray(F)).copy()
    for ld in load_list:
        F[ld["node"], :3] += np.asarray(ld["force"])
    return F


def constrained_conjugate_gradient_solver(K, elements, F, rbe2_list, spc_list,
                                          u_init=None, tol=1e-10,
                                          max_iter=1000, device=None,
                                          dtype=np.float64, eps=1e-30):
    dev = resolve_device(device)
    F = _tensor(F, dtype, dev)
    N, nd = F.shape
    op = _op(_tensor(K, dtype, dev), elements, N, nd, dev)
    cons = Constraints.build(N, nd, spc_list=spc_list, rbe2_list=rbe2_list,
                             dtype=_np_dt(dtype))
    u, _ = cg(op, F, constraints=cons, x0=_opt(u_init, dtype, dev), tol=tol,
              max_iter=max_iter, eps=eps)
    return u


def new_constrained_conjugate_gradient_solver(K, elements, N, rbe2_list,
                                              rbe3_list, spc_list, load_list,
                                              u_init=None, tol=1e-10,
                                              max_iter=1000, device=None,
                                              dtype=np.float64, eps=1e-30):
    dev = resolve_device(device)
    F = apply_loads_to_F(np.zeros((N, 3), _np_dt(dtype)), load_list)
    op = _op(_tensor(K, dtype, dev), elements, N, 3, dev)
    cons = Constraints.build(N, 3, spc_list=spc_list, rbe2_list=rbe2_list,
                             rbe3_list=rbe3_list, dtype=_np_dt(dtype))
    u, _ = cg(op, _tensor(F, dtype, dev), constraints=cons,
              x0=_opt(u_init, dtype, dev), tol=tol, max_iter=max_iter,
              eps=eps)
    return u


def preconditioned_conjugate_gradient_solver(K, elements, F, M_inv,
                                             u_init=None, tol=1e-8,
                                             max_iter=1000, device=None,
                                             dtype=np.float32):
    dev = resolve_device(device)
    F = _tensor(F, dtype, dev)
    op = _op(_tensor(K, dtype, dev), elements, F.shape[0], 3, dev)
    u, _ = cg(op, F, M_inv=_tensor(M_inv, dtype, dev),
              x0=_opt(u_init, dtype, dev), tol=tol, max_iter=max_iter)
    return u


def compute_diagonal_preconditioner(K, elements, N, device=None,
                                    dtype=np.float32):
    dev = resolve_device(device)
    d = _op(_tensor(K, dtype, dev), elements, N, 3, dev).diagonal()
    return torch.where(d.abs() > 0, 1.0 / torch.where(d == 0, 1.0, d),
                       0.0).reshape(N, 3)


def bicgstab_solver(K, elements, F, rbe2, u_init=None, tol=1e-8,
                    max_iter=1000, device=None, dtype=np.float32):
    dev = resolve_device(device)
    F = _tensor(F, dtype, dev)
    N = F.shape[0]
    op = _op(_tensor(K, dtype, dev), elements, N, 3, dev)
    u, _ = bicgstab(op, F, constraints=_fixed_cons(N, rbe2, 3, dtype),
                    x0=_opt(u_init, dtype, dev), tol=tol, max_iter=max_iter)
    return u


def gmres_solver(K, elements, F, u_init=None, tol=1e-8, max_iter=1000,
                 restart=50, device=None, dtype=np.float32):
    dev = resolve_device(device)
    F = _tensor(F, dtype, dev)
    op = _op(_tensor(K, dtype, dev), elements, F.shape[0], 3, dev)
    u, _ = gmres(op, F, x0=_opt(u_init, dtype, dev), tol=tol,
                 max_iter=max_iter, restart=restart)
    return u


def newton_raphson_solver(K_func, elements, F_ext, u_init=None, tol=1e-8,
                          max_iter=50, device=None, dtype=np.float32):
    dev = resolve_device(device)
    F_ext = _tensor(F_ext, dtype, dev)
    N = F_ext.shape[0]

    def op_of(u):
        return _op(_tensor(K_func(u), dtype, dev), elements, N, 3, dev)

    u, _ = newton_raphson(op_of, F_ext, u_init=_opt(u_init, dtype, dev),
                          tol=tol, max_iter=max_iter)
    return u


def vectorized_modal_solver(K_local, M_local, elements, rbe2_node_ids,
                            num_nodes, num_eigs=5, max_iter=20, device=None,
                            dtype=np.float32):
    """Reference-signature modal solve through the inverse-iteration
    solver: the SMALLEST modes (solvers.modal.naive_modal_solver is the
    reference's forward iteration)."""
    dev = resolve_device(device)
    op = _op(_tensor(K_local, dtype, dev), elements, num_nodes, 3, dev)
    Mdiag = modal_mod.lumped_mass_diagonal(_tensor(M_local, dtype, dev),
                                           op.plan)
    cons = _fixed_cons(num_nodes, rbe2_node_ids, 3, dtype)
    lam, modes, _ = modal_mod.modal_solver(op, Mdiag, (num_nodes, 3),
                                           num_eigs, constraints=cons,
                                           max_iter=max_iter)
    return lam, modes
