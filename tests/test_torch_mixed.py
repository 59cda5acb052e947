"""tpufem_torch's mixed solid + shell driver and the packed solver family
against tpufem.

* static_structure_solver on an s4 plate and an s3 plate (grid 4 x 4,
  clamped at x = 0, a transverse and an in-plane load at x = 1) and on
  BASELINE config 3 at n = 2 (box_tet below z = 0.5, box_wedge above, an
  s4 skin on the top face; tpufem's tests/test_solvers.py settings),
  assembled (and clustered for config 3), f64 Jacobi PCG, against
  tpufem's assembled solve: u within 1e-10 relative (max-norm), the same
  status and iteration count.
* The port's operator="packed" config-3 solve (PackedMixedSystem: the tet
  block packed, the wedges and the skin bridged) against tpufem's
  assembled solve at tpufem's own bar (rtol 2e-5, atol 1e-7 max|u|), the
  same with two solid blocks and no shells (rotations exactly zero), and
  PackedConstraints.build(comp=3) against the rotation columns of the
  constraint tables.
* PackedSystem.solve_bicgstab and solve_gmres against tpufem's [N, 3]
  solvers, with the settings and tolerances of tpufem's
  tests/test_packed.py (u within 1e-5 relative and 1e-7 max|u|) on
  smaller meshes (box_tet(1, 1, 2), box_tet(2)): the plain versions of
  the packed kernels take 3-20 ms an apply on the CPU.
  (PackedSystem.modal is held against tpufem's modal_solver in
  tests/test_torch_solvers.py, beside the [N, 3] port, on one tpufem
  run.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements import solid as j_solid
from tpufem.ops.operator import MatrixFreeOperator as JOp
from tpufem.ops.scatter import ScatterPlan as JPlan
from tpufem.solvers import bicgstab as j_bicgstab
from tpufem.solvers import gmres as j_gmres
from tpufem.solvers import static as j_static
from tpufem.solvers.constraints import Constraints as JCons
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.ops import packed as tpp
from tpufem_torch.solvers import cg as t_cg

E, NU = 200.0, 0.3
MAT = {"E": E, "nu": NU, "membrane": (E, NU, 0.05), "bending": (E, NU, 0.05)}



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives (the plain packed kernels are thousands of small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def config3(n=2):
    """tpufem's BASELINE config 3: tets below z = 0.5, wedges above, an s4
    skin on the top face; z = 0 fixed, x and z loads on the top."""
    coords, tets_all = meshgen.box_tet(n, n, n)
    _, wedges_all = meshgen.box_wedge(n, n, n)
    tets = tets_all[coords[tets_all].mean(axis=1)[:, 2] < 0.5]
    wedges = wedges_all[coords[wedges_all].mean(axis=1)[:, 2] > 0.5]
    top = meshgen.boundary_nodes(coords, 2, 1.0)
    grid = top[np.lexsort((coords[top, 1], coords[top, 0]))].reshape(
        n + 1, n + 1)
    quads = np.asarray([[grid[i, j], grid[i + 1, j], grid[i + 1, j + 1],
                         grid[i, j + 1]]
                        for i in range(n) for j in range(n)], np.int32)
    N = coords.shape[0]
    force = np.zeros((N, 6))
    force[top, 0] = 0.01
    force[top, 2] = -0.02
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    return coords, dict(c3d4=tets, c3d6=wedges, s4=quads), force, fixed, top


def _plate(etype):
    gen = meshgen.grid_quad if etype == "s4" else meshgen.grid_tri
    coords, conn = gen(4, 4)
    N = coords.shape[0]
    force = np.zeros((N, 6))
    tip = meshgen.boundary_nodes(coords, 0, 1.0)
    force[tip, 2] = -1e-3
    force[tip, 1] = 2e-3
    return coords, {etype: conn}, force, meshgen.boundary_nodes(coords, 0,
                                                                 0.0)


@pytest.mark.parametrize("case,operator", [
    ("s4", "assembled"), ("s3", "assembled"), ("config3", "assembled"),
    ("config3", "clustered")])
def test_static_mixed_matches_tpufem(case, operator):
    if case == "config3":
        coords, blocks, force, fixed, _ = config3()
    else:
        coords, blocks, force, fixed = _plate(case)
    kw = dict(material=MAT, precondition=True, max_iter=6000,
              tol=1e-12 * float(np.linalg.norm(force)), **blocks)
    uj, ij = j_static.static_structure_solver(coords, force, fixed,
                                              operator=operator, **kw)
    ut, it = tpufem_torch.static_structure_solver(
        coords, force, fixed, operator=operator, dtype=torch.float64,
        device="cpu", **kw)
    assert int(it.status) == int(ij.status) == t_cg.CONVERGED
    assert int(it.iterations) == int(ij.iterations)
    assert ut.shape == (coords.shape[0], 6)
    assert _rel(ut, uj) <= 1e-10
    assert not ut[fixed].any()
    if case != "config3":
        # the drilling rotation has no stiffness: it stays zero
        assert not ut[:, 5].any()


def test_packed_mixed_config3_matches_tpufem():
    coords, blocks, force, fixed, top = config3()
    kw = dict(material=MAT, tol=1e-11, max_iter=6000, precondition=True,
              **blocks)
    uj, ij = j_static.static_structure_solver(coords, force, fixed, **kw)
    assert int(ij.status) == t_cg.CONVERGED
    ut, it = tpufem_torch.static_structure_solver(
        coords, force, fixed, operator="packed", dtype=torch.float64,
        device="cpu", **kw)
    assert int(it.status) == t_cg.CONVERGED
    u, uj = ut.numpy(), np.asarray(uj)
    assert np.abs(u[top, 0]).min() > 0
    np.testing.assert_allclose(u, uj, rtol=2e-5, atol=1e-7 * np.abs(uj).max())
    # the same operator applied through the system's pieces
    system = tpufem_torch.PackedMixedSystem(coords, blocks, MAT,
                                            fixed_nodes=fixed,
                                            dtype=torch.float64,
                                            device="cpu")
    assert system.has_rot and len(system.pc.planes) == 2
    assert set(system.timings) == {"primary", "solids", "shells",
                                   "constraints", "diagonal"}
    X = system.pack6(torch.tensor(uj))
    assert torch.equal(system.unpack6(X), torch.tensor(uj))


def test_packed_multi_solid_matches_tpufem():
    """Two solid blocks, no shells: one packed plane, rotations zero."""
    coords, blocks, force, fixed, _ = config3()
    blocks.pop("s4")
    kw = dict(material=MAT, tol=1e-11, max_iter=6000, precondition=True,
              **blocks)
    uj, _ = j_static.static_structure_solver(coords, force, fixed, **kw)
    ut, it = tpufem_torch.static_structure_solver(
        coords, force, fixed, operator="packed", dtype=torch.float64,
        device="cpu", **kw)
    assert int(it.status) == t_cg.CONVERGED
    assert not ut[:, 3:].any()
    uj = np.asarray(uj)
    np.testing.assert_allclose(ut.numpy(), uj, rtol=2e-5,
                               atol=1e-7 * np.abs(uj).max())


def test_packed_constraints_comp3():
    """The rotation plane carries the rotation columns of the tables: its
    mask, its SPC values and its RBE2/RBE3 rows, translated to the plane's
    positions (RBE2/RBE3 couple component-wise)."""
    coords, conn = meshgen.box_tet(2, 2, 2)
    N = coords.shape[0]
    top = meshgen.boundary_nodes(coords, 2, 1.0)
    cons = tpufem_torch.Constraints.build(
        N, 6, [{"node": 0, "dofs": [0, 4], "value": 0.5},
               {"node": 1, "dofs": [3, 4, 5], "value": 0.0}],
        [{"master": int(top[0]), "slaves": [int(t) for t in top[1:3]],
          "dofs": [1, 3, 5]}],
        [{"master": int(top[-1]), "slaves": [int(t) for t in top[3:6]],
          "dofs": [2, 4], "weights": [1.0, 2.0, 0.5]}])
    plan = tpp.PackedPlan.build(coords, conn, N, device="cpu")
    rng = np.random.default_rng(4)
    u6 = rng.standard_normal((N, 6))
    want = cons.apply_state(torch.tensor(u6))
    for comp in (0, 3):
        pc = tpp.PackedConstraints.build(cons, plan, torch.float64, comp=comp)
        X = plan.pack(torch.tensor(u6[:, comp:comp + 3]))
        got = plan.unpack(pc.apply_state(X))
        assert torch.equal(got, want[:, comp:comp + 3]), comp
        assert torch.equal(plan.unpack(pc.mask),
                           torch.tensor(cons.mask2d[:, comp:comp + 3]))
        assert torch.equal(pc.free_mask, pc.mask.reshape(-1))


def _packed(coords, conn, etype, precondition="jacobi"):
    N = coords.shape[0]
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, etype, E, NU, n_nodes=N, dtype=torch.float64,
        device="cpu")
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    return (tpufem_torch.PackedSystem(op, fixed_nodes=fixed,
                                      precondition=precondition), fixed)


def _ref_op(coords, conn, etype):
    K = j_solid.stiffness(jnp.asarray(coords), jnp.asarray(conn), etype, E,
                          NU)
    return JOp(K=K, plan=JPlan.build(conn, coords.shape[0], 3))


def test_packed_bicgstab_matches_tpufem():
    coords, conn = meshgen.box_tet(1, 1, 2)
    N = coords.shape[0]
    system, fixed = _packed(coords, conn, "c3d4")
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 0] = 1e3
    u, info = system.solve_bicgstab(b, tol=1e-10, max_iter=4000)
    assert int(info.status) == t_cg.CONVERGED
    u_ref, info_ref = j_bicgstab.bicgstab(
        _ref_op(coords, conn, "c3d4"), jnp.asarray(b),
        constraints=JCons.fixed(N, fixed, 3), tol=1e-10, max_iter=4000)
    assert int(info_ref.status) == t_cg.CONVERGED
    u_ref = np.asarray(u_ref)
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-5,
                               atol=1e-7 * np.abs(u_ref).max())


@pytest.mark.parametrize("precondition", [False, "jacobi", "block"])
def test_packed_gmres_matches_tpufem(precondition):
    """GMRES left-Jacobi when the system has scalar Jacobi; without a
    preconditioner under block Jacobi (a callable), as in tpufem."""
    coords, conn = meshgen.box_tet(2, 2, 2)
    N = coords.shape[0]
    system, fixed = _packed(coords, conn, "c3d4", precondition)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1e3
    u, info = system.solve_gmres(b, tol=1e-8, max_iter=2000, restart=40)
    assert int(info.status) == t_cg.CONVERGED
    jop = _ref_op(coords, conn, "c3d4")
    mj = None
    if precondition == "jacobi":
        d = np.asarray(jop.diagonal()).reshape(N, 3)
        mask = np.ones((N, 3))
        mask[fixed] = 0.0
        mj = jnp.asarray(mask / d)
    u_ref, info_ref = j_gmres.gmres(
        jop, jnp.asarray(b), constraints=JCons.fixed(N, fixed, 3), M_inv=mj,
        tol=1e-8, max_iter=2000, restart=40)
    assert int(info_ref.status) == t_cg.CONVERGED
    u_ref = np.asarray(u_ref)
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-5,
                               atol=1e-7 * np.abs(u_ref).max())
