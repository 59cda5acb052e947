"""tpufem_torch's PackedHaloFEM (parallel.packed_dist) on a PartMesh
against tpufem's and against the port's single-device packed operator.

At box_tet10(3, 3, 6) the plan's 64-cluster tile puts every real cluster
and block into part 0 when a cluster holds tpufem's 32 elements, so no row
is exchanged; with 8 elements a cluster the real clusters span two or
three parts and both exchanges run.  So: the partition tables are bitwise
tpufem's for both cluster sizes (geometry to 1e-14 relative, the jacobian
einsums' order), the apply agrees with tpufem's jitted shard_map apply to
rtol 1e-12 (f64) at 2 and 4 parts with 8 elements a cluster, and it is
bitwise the port's single-device PackedPartialOperator(fuse="") on the
same window_buckets=0 plan.  tpufem's interpret-mode PCG inside shard_map
is not run (its own test file takes 300 s); the port's PCG is held against
a dense solve, and 20 iterations of it (scalar and block Jacobi) against
the single-device PackedSystem.  dist_cost_model's
ghost counts are the partition's Gx and Gc.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.parallel import dist as jd
from tpufem.parallel import packed_dist as jpd
from tpufem.utils import meshgen

from tpufem_torch.elements import solid as t_solid
from tpufem_torch.ops.assembly import assemble_dense
from tpufem_torch.ops.packed import (BlockJacobi, PackedPartialOperator,
                                     PackedPlan, PackedSystem)
from tpufem_torch.parallel import dist as td
from tpufem_torch.parallel import packed_dist as tpd
from tpufem_torch.scripts import dist_cost_model

E, NU = 200e9, 0.3
INT_TABLES = ("win_nodes", "wslot", "jslot", "lconn", "cinc", "winc",
              "slotidx", "xsend", "xrecv", "xmask", "csend", "crecv",
              "cmask", "new_from_old", "old_from_new")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _box():
    coords, conn = meshgen.box_tet10(3, 3, 6, 1.0, 1.0, 2.0)
    return coords, conn


@pytest.mark.parametrize("ec,n_parts", [(32, 2), (32, 4), (8, 2), (8, 4)])
def test_partition_tables_bitwise(ec, n_parts):
    coords, conn = _box()
    jp = jpd.PackedDistPartition.build(coords, conn, "c3d10", E, NU,
                                       n_parts, elems_per_cluster=ec)
    tp = tpd.PackedDistPartition.build(coords, conn, "c3d10", E, NU,
                                       n_parts, elems_per_cluster=ec,
                                       device="cpu")
    for t in INT_TABLES:
        _same(getattr(jp, t), getattr(tp, t))
    assert dataclasses.astuple(jp.meta) == dataclasses.astuple(tp.meta)
    assert jp.dN == tp.dN
    for g in ("Jinv", "W"):
        a, b = np.asarray(getattr(jp, g)), getattr(tp, g).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(b, a) <= 1e-14, g
    # exchanges run only where real clusters span parts
    m = tp.meta
    assert bool(m.x_rounds) == bool(m.c_rounds) == (ec == 8)
    # the cost model's ghost counts are the partition's
    plan = PackedPlan.build(coords, conn, coords.shape[0], ec,
                            window_buckets=0, device="cpu")
    per, (Bp, Nbp) = dist_cost_model.ghost_counts(plan, n_parts)
    assert (Bp, Nbp) == (m.Bp, m.Nbp)
    assert max(1, max(g[0] for g in per)) == m.Gx
    assert max(1, max(g[1] for g in per)) == m.Gc


@pytest.fixture(scope="module")
def problem():
    coords, conn = _box()
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 2.0), 0] = 1e3
    return coords, conn, N, fixed, b


def _tol(b):
    return 1e-8 * float(np.linalg.norm(b))


@pytest.mark.parametrize("n_parts", [2, 4])
def test_spmv_matches_tpufem_and_single_device(problem, n_parts):
    coords, conn, N, fixed, b = problem
    jf, jp = jpd.build_packed_halo_fem(
        coords, conn, "c3d10", E, NU, mesh=jd.make_mesh_1d(n_parts),
        precondition=False, elems_per_cluster=8)
    tf, tp = tpd.build_packed_halo_fem(
        coords, conn, "c3d10", E, NU,
        mesh=td.PartMesh(n_parts, device="cpu"), precondition=False,
        elems_per_cluster=8)
    u = np.random.default_rng(0).standard_normal((N, 3))
    X = tp.pack_np(u)
    _same(jp.pack_np(u), X)
    F_j = np.asarray(jf.spmv(jnp.asarray(X)))
    F_t = tf.spmv(X)
    np.testing.assert_allclose(F_t.numpy(), F_j, rtol=1e-12,
                               atol=1e-12 * np.abs(F_j).max())
    # two applies bitwise; the plain stages are what the wrappers ran
    assert torch.equal(tf.spmv(X), F_t)
    # bitwise the single-device staged operator on the same plan
    plan = PackedPlan.build(coords, conn, N, 8, window_buckets=0,
                            device="cpu")
    op = PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                     plan=plan, fuse="", dtype=torch.float64,
                                     device="cpu")
    F1 = plan.unpack(op(plan.pack(torch.as_tensor(u))))
    assert torch.equal(torch.as_tensor(tp.unpack_np(F_t)), F1)
    _same(tp.unpack_np(X), u)


@pytest.fixture(scope="module")
def single(problem):
    """The port's single-device staged operator on the same
    window_buckets=0 plan (8 elements a cluster)."""
    coords, conn, N, fixed, b = problem
    plan = PackedPlan.build(coords, conn, N, 8, window_buckets=0,
                            device="cpu")
    op = PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                     plan=plan, fuse="", dtype=torch.float64,
                                     device="cpu")
    return plan, op


def _system(problem, pre):
    coords, conn, N, fixed, b = problem
    return tpd.build_packed_halo_fem(
        coords, conn, "c3d10", E, NU, mesh=td.PartMesh(4, device="cpu"),
        fixed_nodes=fixed, precondition=pre, elems_per_cluster=8)


def test_pcg_matches_dense_reference(problem, single):
    coords, conn, N, fixed, b = problem
    fem, part = _system(problem, "jacobi")
    uX, info = fem.pcg(part.pack_np(b), tol=_tol(b), max_iter=4000)
    assert int(info.status) == 1
    u = part.unpack_np(uX)
    K = t_solid.stiffness(torch.as_tensor(coords), torch.as_tensor(conn),
                          "c3d10", E, NU)
    A = assemble_dense(K, conn, N).numpy()
    free = np.ones((N, 3), bool)
    free[fixed] = False
    free = free.reshape(-1)
    u_ref = np.zeros(3 * N)
    u_ref[free] = np.linalg.solve(A[np.ix_(free, free)], b.reshape(-1)[free])
    u_ref = u_ref.reshape(N, 3)
    np.testing.assert_allclose(u, u_ref, rtol=1e-5,
                               atol=1e-8 * np.abs(u_ref).max())


@pytest.mark.parametrize("pre", ["jacobi", "block"])
def test_pcg_window_matches_single_device(problem, single, pre):
    """20 PCG iterations against the single-device PackedSystem on the
    same plan (the same operator bitwise, the dots summed in another
    order), scalar and block Jacobi; the block planes are the
    single-device BlockJacobi's."""
    coords, conn, N, fixed, b = problem
    plan, op = single
    fem, part = _system(problem, pre)
    system = PackedSystem(op, fixed_nodes=fixed, precondition=pre)
    u1, info1 = system.solve(b, tol=0.0, max_iter=20)
    u2, info2 = fem.pcg(part.pack_np(b), tol=0.0, max_iter=20)
    assert int(info1.iterations) == int(info2.iterations) == 20
    assert _rel(part.unpack_np(u2), u1.numpy()) <= 1e-10
    np.testing.assert_allclose(info2.history.numpy(),
                               info1.history.numpy(), rtol=1e-10)
    if pre == "block":
        inv_d, inv_o = fem.M_inv
        bj = system.M_inv
        assert isinstance(bj, BlockJacobi)
        np.testing.assert_allclose(part.unpack_np(inv_d),
                                   plan.unpack(bj.inv_d).numpy(),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(
            part.unpack_np(inv_o), plan.unpack(bj.inv_o).numpy(),
            rtol=1e-12, atol=1e-12 * float(bj.inv_o.abs().max()))


def test_interior_split_nontrivial():
    """Interior clusters exist at box_tet10(6, 6, 12) in 2 parts (tpufem's
    cut) and their windows read owned blocks or the zero scratch row."""
    coords, conn = meshgen.box_tet10(6, 6, 12)
    tp = tpd.PackedDistPartition.build(coords, conn, "c3d10", E, NU, 2,
                                       device="cpu")
    m = tp.meta
    assert m.interior_cut > 0
    win = tp.win_nodes[:, :m.interior_cut]
    assert ((win < m.Nbp) | (win == m.Nbp + m.Gx)).all()
    plan = PackedPlan.build(coords, conn, coords.shape[0],
                            window_buckets=0, device="cpu")
    per, _ = dist_cost_model.ghost_counts(plan, 2)
    assert (max(g[0] for g in per), max(g[1] for g in per)) == (m.Gx, m.Gc)
    rows = dist_cost_model.cost_rows(plan, conn.shape[0], 10, (2,),
                                     rate=1e10, link_bw=1e11)
    assert rows[0]["ghost_x_rows_max"] == m.Gx
    assert rows[0]["bytes_per_apply"] == (m.Gx + m.Gc) * 1536


def test_cost_model_main():
    """The script's table and JSON line at box_tet10(6): rows for the
    asked part counts, at the given rate and link bandwidth."""
    lines = []
    rows = dist_cost_model.main(["6", "--parts", "2,4", "--rate-gnnz", "10",
                                 "--link-gbs", "100"], log=lines.append)
    assert [r["parts"] for r in rows] == [2, 4]
    assert lines[0].startswith("mesh: box_tet10(6) M=1296")
    assert '"rate_nnz_per_s": 10000000000.0' in lines[-1]
    r = rows[1]
    assert r["t_comm_ms"] == r["bytes_per_apply"] / 100e9 * 1e3
    assert r["t_comp_ms"] == 1296 * 900 / 4 / 10e9 * 1e3
