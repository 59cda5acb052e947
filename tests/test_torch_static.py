"""tpufem_torch's static solver against tpufem's.

static_structure_solver on box_tet10(2, 2, 3) in f64 (z = 0 fixed, a load
on the top face, [N, 6] state, Jacobi PCG to an absolute tolerance of
1e-8 ||b||): with operator="assembled", "clustered" and "partial", the
same status, iteration counts within 3% of tpufem's, and u within 1e-8
relative (max-norm).  The flagship step of __graft_entry__.entry (f32 stiffness,
MatrixFreeOperator, Jacobi, 50 CG iterations) gives u within 1e-4
relative of tpufem's: f32 sums in another order, over 50 iterations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from tpufem.solvers import static as j_static
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.solvers import cg as t_cg
from tpufem_torch.solvers import static as t_static

E, NU = 200e9, 0.3
MATERIAL = {"E": E, "nu": NU}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    coords, conn = meshgen.box_tet10(2, 2, 3)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    force = np.zeros((N, 6))
    top = meshgen.boundary_nodes(coords, 2, 1.0)
    force[top, 2] = -1e3
    force[top, 0] = 2e2
    tol = 1e-8 * float(np.linalg.norm(force))
    return coords, conn, fixed, force, tol


@pytest.mark.parametrize("operator", ["assembled", "clustered", "partial"])
def test_static_solver_matches_tpufem(problem, operator):
    coords, conn, fixed, force, tol = problem
    kw = dict(material=MATERIAL, c3d10=conn, operator=operator,
              precondition=True, tol=tol, max_iter=2000)
    uj, ij = j_static.static_structure_solver(coords, force, fixed, **kw)
    timings = {}
    ut, it = tpufem_torch.static_structure_solver(
        coords, force, fixed, dtype=torch.float64, device="cpu",
        timings=timings, **kw)
    assert int(it.status) == int(ij.status) == t_cg.CONVERGED
    assert abs(int(it.iterations) - int(ij.iterations)) <= 0.03 * int(
        ij.iterations)
    uj = np.asarray(uj)
    assert ut.shape == uj.shape == (coords.shape[0], 6)
    assert float(np.abs(ut.numpy() - uj).max() / np.abs(uj).max()) <= 1e-8
    assert not ut[:, 3:].any() and not ut[fixed].any()
    assert set(timings) == {"stiffness", "plans", "operator", "jacobi",
                            "solve"}


def test_static_model_parts(problem):
    """build_static_model's two operators agree, and the Jacobi inverse is
    zero on the rotation DOFs."""
    coords, conn, _, _, _ = problem
    ma = t_static.build_static_model(coords, {"c3d10": conn}, MATERIAL,
                                     dtype=torch.float64, device="cpu")
    mc = t_static.build_static_model(coords, {"c3d10": conn}, MATERIAL,
                                     dtype=torch.float64,
                                     operator="clustered", device="cpu")
    u = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (coords.shape[0], 6)))
    Fa, Fc = ma(u), mc(u)
    assert not Fa[:, 3:].any()
    assert float((Fa - Fc).abs().max() / Fa.abs().max()) <= 1e-12
    Mi = ma.jacobi_preconditioner()
    assert not Mi[:, 3:].any() and bool((Mi[:, :3] > 0).all())


def test_unported_paths_raise(problem):
    """"dense" is no operator and "c3d9" no element type (every operator
    of tpufem is ported: "partial" in test_static_solver_matches_tpufem,
    shell blocks and mixed packed models in tests/test_torch_mixed.py)."""
    coords, conn, fixed, force, _ = problem
    for kw, err in ((dict(c3d10=conn, operator="dense"), ValueError),
                    (dict(blocks={"c3d9": conn}, operator="partial"),
                     ValueError)):
        with pytest.raises(err):
            tpufem_torch.static_structure_solver(
                coords, force, fixed, material=MATERIAL, device="cpu", **kw)


def test_constraints_on_a_field():
    c = tpufem_torch.Constraints.fixed(4, [1, 3], 6, dtype=np.float32)
    u = torch.ones((4, 6), dtype=torch.float64)
    v = c.apply_state(u)
    assert v.dtype == torch.float64
    assert v[[0, 2]].eq(1).all() and not v[[1, 3]].any()
    assert torch.equal(c.project_residual(u), v)


def test_graft_entry_flow_f32():
    """__graft_entry__'s flagship forward step, through both packages."""
    fn, (coords_j, force_j) = __graft_entry__.entry()
    uj, rj = jax.jit(fn)(coords_j, force_j)
    coords, conn = meshgen.box_tet10(3, 3, 6, 1.0, 1.0, 2.0)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    cons = tpufem_torch.Constraints.fixed(N, fixed, 3, dtype=np.float32)
    plan = tpufem_torch.ScatterPlan.build(conn, N, 3, device="cpu")
    K = tpufem_torch.solid.stiffness(torch.tensor(np.asarray(coords_j)),
                                     torch.from_numpy(conn), "c3d10", E, NU)
    op = tpufem_torch.MatrixFreeOperator(K, plan)
    Minv = tpufem_torch.diagonal_preconditioner([op])
    ut, info = tpufem_torch.cg(op, torch.tensor(np.asarray(force_j)),
                               constraints=cons, M_inv=Minv, tol=1e-6,
                               max_iter=50)
    assert ut.dtype == torch.float32 and int(info.iterations) == 50
    uj = np.asarray(uj)
    assert float(np.abs(ut.numpy() - uj).max() / np.abs(uj).max()) <= 1e-4
    # the final residual (50 iterations take it to 4e-3 of the first)
    # agrees to 1e-5 of the first (5e-6 measured; u: 5e-6)
    r0 = float(info.history[0])
    assert abs(float(info.residual_norm) - float(rj)) <= 1e-5 * r0
