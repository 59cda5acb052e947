"""SPC values, RBE2 and RBE3 in the port against tpufem.

Constraints.build gives tpufem's tables bitwise (3 and 6 DOFs per node)
and its apply_state / project_residual agree with tpufem's on seeded
fields; PackedConstraints.build gives tpufem's packed tables (the RBE3
segment ids as the port's padded table, rotation DOFs dropped) and the
same packed enforcement.  On box_tet10(3) in f64 with tpufem's
constrained workload (SPC with a value, an RBE2 and an RBE3 set), the
port's PackedSystem solve agrees with tpufem's cg on its assembled
operator within the tolerances of tpufem's own parity test, and
static_structure_solver(operator="packed") agrees with tpufem's
assembled static solve within those of its packed static tests.  tpufem's
side runs no Pallas kernel: its element stiffness on the CPU is plain
jnp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements import solid as j_solid
from tpufem.ops import packed as j_packed
from tpufem.ops.operator import MatrixFreeOperator as JMatrixFree
from tpufem.ops.scatter import ScatterPlan as JScatterPlan
from tpufem.solvers import cg as j_cg
from tpufem.solvers import constraints as j_cons
from tpufem.solvers import static as j_static
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.solvers import cg as t_cg
from tpufem_torch.solvers import constraints as t_cons

E, NU = 200e9, 0.3
FIELDS = ("free_mask", "spc_dofs", "spc_values", "rbe2_slave_dofs",
          "rbe2_master_dofs", "rbe3_slave_dofs", "rbe3_weights", "rbe3_cid",
          "rbe3_master_dofs", "rbe3_weight_sums", "mask2d", "spc_const2d")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lists(base, top, nd=3):
    """tpufem's constrained workload of test_packed_constraints_parity:
    the base pinned but for two nodes, one with a value, an RBE2 and an
    RBE3 set on the top face (rotation DOFs too when nd = 6)."""
    dofs = list(range(nd))
    spc = [{"node": int(n), "dofs": dofs, "value": 0.0} for n in base[:-2]]
    spc += [{"node": int(base[-2]), "dofs": [2], "value": 1e-4}]
    rbe2 = [{"master": int(top[0]), "slaves": [int(t) for t in top[1:4]],
             "dofs": dofs}]
    rbe3 = [{"master": int(top[-1]), "slaves": [int(t) for t in top[4:8]],
             "dofs": dofs, "weights": [1.0, 2.0, 1.0, 0.5]}]
    return spc, rbe2, rbe3


@pytest.fixture(scope="module")
def mesh():
    coords, conn = meshgen.box_tet10(3, 3, 3)
    base = np.asarray(meshgen.boundary_nodes(coords, 2, 0.0))
    top = np.asarray(meshgen.boundary_nodes(coords, 2, 1.0))
    return coords, conn, base, top


@pytest.mark.parametrize("nd", [3, 6])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_constraints_build_matches_tpufem(mesh, nd, dtype):
    coords, _, base, top = mesh
    N = coords.shape[0]
    spc, rbe2, rbe3 = _lists(base, top, nd)
    a = j_cons.Constraints.build(N, nd, spc, rbe2, rbe3, fixed_nodes=[1],
                                 dtype=dtype)
    b = t_cons.Constraints.build(N, nd, spc, rbe2, rbe3, fixed_nodes=[1],
                                 dtype=dtype)
    for name in FIELDS:
        x, y = np.asarray(getattr(a, name)), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.has_inhomogeneous == b.has_inhomogeneous
    u = np.random.default_rng(nd).standard_normal((N, nd)).astype(dtype)
    want = np.asarray(a.apply_state(jnp.asarray(u)))
    got = b.apply_state(torch.as_tensor(u)).numpy()
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() \
        if dtype == np.float32 else np.array_equal(got, want)
    assert np.array_equal(b.project_residual(torch.as_tensor(u)).numpy(),
                          np.asarray(a.project_residual(jnp.asarray(u))))
    # the SPC-only path (no sets): mask and the values
    a = j_cons.Constraints.build(N, nd, spc, dtype=dtype)
    b = t_cons.Constraints.build(N, nd, spc, dtype=dtype)
    assert np.array_equal(b.apply_state(torch.as_tensor(u)).numpy(),
                          np.asarray(a.apply_state(jnp.asarray(u))))


def test_rbe3_table_in_entry_order():
    cid = np.array([1, 0, 1, 2, 1, 0], np.int32)
    assert t_cons.rbe3_table(cid, 4).tolist() == [
        [1, 5, 6], [0, 2, 4], [3, 6, 6], [6, 6, 6]]


@pytest.mark.parametrize("nd", [3, 6])
def test_packed_constraints_match_tpufem(mesh, nd):
    coords, conn, base, top = mesh
    N = coords.shape[0]
    spc, rbe2, rbe3 = _lists(base, top, nd)
    jc = j_cons.Constraints.build(N, nd, spc, rbe2, rbe3, dtype=np.float64)
    tc = t_cons.Constraints.build(N, nd, spc, rbe2, rbe3, dtype=np.float64)
    jplan = j_packed.PackedPlan.build(coords, conn, N)
    tplan = tpufem_torch.PackedPlan.build(coords, conn, N, device="cpu")
    jp = j_packed.PackedConstraints.build(jc, jplan, np.float64)
    tp = tpufem_torch.PackedConstraints.build(tc, tplan, torch.float64)
    assert np.array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    assert np.array_equal(tp.spc_const.numpy(), np.asarray(jp.spc_const))
    assert np.array_equal(tp.rbe2_slave.numpy(), np.asarray(jp.rbe2_slave))
    assert np.array_equal(tp.rbe2_master.numpy(), np.asarray(jp.rbe2_master))
    assert np.array_equal(tp.rbe3_slave[:-1].numpy(),
                          np.asarray(jp.rbe3_slave))
    assert np.array_equal(tp.rbe3_weights[:-1].numpy(),
                          np.asarray(jp.rbe3_weights))
    assert np.array_equal(tp.rbe3_master.numpy(), np.asarray(jp.rbe3_master))
    assert np.array_equal(tp.rbe3_wsum.numpy(), np.asarray(jp.rbe3_wsum))
    assert np.array_equal(tp.rbe3_table.numpy(), t_cons.rbe3_table(
        np.asarray(jp.rbe3_cid), np.asarray(jp.rbe3_master).size))
    X = np.random.default_rng(7).standard_normal((tplan.meta.n_blocks, 384))
    want = np.asarray(jp.apply_state(jnp.asarray(X)))
    got = tp.apply_state(torch.as_tensor(X)).numpy()
    assert np.abs(got - want).max() <= 1e-15 * np.abs(want).max()
    assert np.array_equal(tp.project_residual(torch.as_tensor(X)).numpy(),
                          np.asarray(jp.project_residual(jnp.asarray(X))))


def test_constrained_packed_solve_matches_tpufem(mesh):
    """tpufem's test_packed_constraints_parity, the port's packed system
    against tpufem's cg on its assembled [N, 3] operator."""
    coords, conn, base, top = mesh
    N = coords.shape[0]
    spc, rbe2, rbe3 = _lists(base, top)
    b = np.zeros((N, 3))
    b[top, 0] = 2e3
    b[top, 2] = -1e3
    tc = t_cons.Constraints.build(N, 3, spc, rbe2, rbe3, dtype=np.float64)
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, dtype=torch.float64,
        device="cpu")
    system = tpufem_torch.PackedSystem(op, constraints=tc,
                                       precondition="jacobi")
    u, info = system.solve(b, tol=1e-7, max_iter=4000)
    assert int(info.status) == t_cg.CONVERGED

    jc = j_cons.Constraints.build(N, 3, spc, rbe2, rbe3, dtype=np.float64)
    K = j_solid.stiffness(jnp.asarray(coords), jnp.asarray(conn), "c3d10",
                          E, NU)
    op_ref = JMatrixFree(K=K, plan=JScatterPlan.build(conn, N, 3))
    dref = op_ref.diagonal().reshape(N, 3)
    Minv = jnp.where(jnp.abs(dref) > 0, 1.0 / dref, 0.0) * jc.mask2d
    u_ref, info_ref = j_cg.cg(op_ref, jnp.asarray(b) * jc.mask2d,
                              constraints=jc, M_inv=Minv, tol=1e-7,
                              max_iter=4000)
    assert int(info_ref.status) == j_cg.CONVERGED
    u_ref = np.asarray(u_ref)
    scale = np.abs(u_ref).max()
    un = u.numpy()
    np.testing.assert_allclose(un, u_ref, rtol=1e-4, atol=1e-6 * scale)
    # the constraint semantics hold on the port's solution
    assert abs(un[int(base[-2]), 2] - 1e-4) < 1e-9 + 1e-5 * scale
    np.testing.assert_allclose(
        un[[int(t) for t in top[1:4]]],
        np.broadcast_to(un[int(top[0])], (3, 3)), rtol=0, atol=1e-12)
    w = np.array([1.0, 2.0, 1.0, 0.5])
    avg = (w[:, None] * un[[int(t) for t in top[4:8]]]).sum(0) / w.sum()
    np.testing.assert_allclose(un[int(top[-1])], avg, rtol=0,
                               atol=1e-10 * scale)


def test_static_packed_matches_tpufem():
    """static_structure_solver(operator="packed") with 6-DOF SPC/RBE2/RBE3
    tables against tpufem's assembled static solve: [N, 6] with zero
    rotations, within tpufem's packed static tolerances."""
    coords, conn = meshgen.box_tet10(2, 2, 3)
    N = coords.shape[0]
    base = np.asarray(meshgen.boundary_nodes(coords, 2, 0.0))
    top = np.asarray(meshgen.boundary_nodes(coords, 2, 1.0))
    spc, rbe2, _ = _lists(base, top, 6)
    force = np.zeros((N, 6))
    force[top, 0] = 2e2
    force[top, 2] = -1e3
    kw = dict(material={"E": E, "nu": NU}, c3d10=conn, precondition=True,
              tol=1e-10 * float(np.linalg.norm(force)), max_iter=4000)
    jc = j_cons.Constraints.build(N, 6, spc, rbe2, dtype=np.float64)
    uj, ij = j_static.static_structure_solver(coords, force, constraints=jc,
                                              **kw)
    tc = t_cons.Constraints.build(N, 6, spc, rbe2, dtype=np.float64)
    ut, it = tpufem_torch.static_structure_solver(
        coords, force, constraints=tc, operator="packed",
        dtype=torch.float64, device="cpu", **kw)
    assert int(it.status) == int(ij.status) == t_cg.CONVERGED
    uj = np.asarray(uj)
    assert ut.shape == uj.shape == (N, 6) and not ut[:, 3:].any()
    np.testing.assert_allclose(ut.numpy(), uj, rtol=2e-5,
                               atol=1e-7 * np.abs(uj).max())
