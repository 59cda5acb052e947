"""tpufem_torch's DistFEM and HaloFEM (parallel.dist, parallel.halo) on a
PartMesh against tpufem's on its 8-device CPU mesh.

The partition tables are built from the same numpy element stiffness and
labels and must be bitwise tpufem's; each spmv agrees with tpufem's
jitted shard_map spmv to rtol 1e-12 (f64; each package computes its own
K, which differ by roundoff); each PCG ends in tpufem's iteration count
with u within 1e-10.  Also: the PartMesh collectives, padding rows,
the Jacobi diagonal, determinism and agreement across part counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements import solid as j_solid
from tpufem.parallel import dist as jd
from tpufem.parallel import halo as jh
from tpufem.parallel.partition import partition_elements
from tpufem.utils import meshgen

from tpufem_torch.parallel import dist as td
from tpufem_torch.parallel import halo as th

E, NU = 200.0, 0.3


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


@pytest.fixture(scope="module")
def box():
    coords, conn = meshgen.box_tet(3, 3, 3)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    labels, _ = partition_elements(conn, "c3d4", 8, 0)
    K = np.asarray(jax.jit(lambda c: j_solid.stiffness(
        c, jnp.asarray(conn), "c3d4", E, NU))(jnp.asarray(coords)))
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 0] = 0.02
    return coords, conn, N, fixed, labels, K, b


SYSTEMS = {
    "dist": (jd.build_distributed_fem, td.build_distributed_fem,
             jd.DistPartition, td.DistPartition,
             ("conn", "inc", "new_from_old", "old_from_new")),
    "halo": (jh.build_halo_fem, th.build_halo_fem, jh.HaloPartition,
             th.HaloPartition,
             ("conn_local", "inc", "send_idx", "recv_slot", "recv_mask",
              "new_from_old", "old_from_new")),
}


@pytest.fixture(scope="module")
def systems(box):
    coords, conn, N, fixed, labels, K, b = box
    out = {}
    for name, (jbuild, tbuild, *_rest) in SYSTEMS.items():
        jf, jp = jbuild(coords, conn, "c3d4", E, NU,
                        mesh=jd.make_mesh_1d(8), fixed_nodes=fixed,
                        labels=labels)
        tf, tp = tbuild(coords, conn, "c3d4", E, NU,
                        mesh=td.make_mesh_1d(8, device="cpu"),
                        fixed_nodes=fixed, labels=labels)
        out[name] = (jf, jp, tf, tp)
    return out


def _to_new(part, u):
    """[N, c] -> the new order (host numpy, tpufem's rule)."""
    m = part.meta
    out = np.zeros((m.n_parts * m.block_rows, u.shape[1]), u.dtype)
    out[np.asarray(part.new_from_old)] = u
    return out


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_partition_tables_bitwise(box, name):
    coords, conn, N, fixed, labels, K, b = box
    _, _, jcls, tcls, tables = SYSTEMS[name]
    jp = jcls.build(K, conn, N, labels, 8, 3)
    tp = tcls.build(K, conn, N, labels, 8, 3)
    for t in tables:
        _same(getattr(jp, t), getattr(tp, t))
    _same(jp.K, tp.K)
    assert dataclasses.astuple(jp.meta) == dataclasses.astuple(tp.meta)
    # the element stiffness may also come as a tensor
    tp2 = tcls.build(torch.as_tensor(K), conn, N, labels, 8, 3)
    _same(tp.K, tp2.K)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_spmv_matches_tpufem(box, systems, name):
    coords, conn, N, fixed, labels, K, b = box
    jf, jp, tf, tp = systems[name]
    u = np.random.default_rng(0).standard_normal((N, 3))
    un = _to_new(jp, u)
    F_j = np.asarray(jf.spmv(jnp.asarray(un)))
    F_t = tf.spmv(torch.as_tensor(un))
    assert F_t.shape == F_j.shape and F_t.dtype == torch.float64
    np.testing.assert_allclose(F_t.numpy(), F_j, rtol=1e-12,
                               atol=1e-12 * np.abs(F_j).max())
    np.testing.assert_allclose(tf.M_inv.numpy(), np.asarray(jf.M_inv),
                               rtol=1e-12, atol=0)
    _same(jf.free_mask, tf.free_mask)
    # to_new / to_old are tpufem's
    _same(un, tp.to_new(u))
    _same(u, tp.to_old(torch.as_tensor(un)))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_pcg_matches_tpufem(box, systems, name):
    coords, conn, N, fixed, labels, K, b = box
    jf, jp, tf, tp = systems[name]
    bn = _to_new(jp, b)
    u_j, info_j = jf.pcg(jnp.asarray(bn), tol=1e-12, max_iter=2000)
    u_t, info_t = tf.pcg(torch.as_tensor(bn), tol=1e-12, max_iter=2000)
    assert int(info_j.status) == int(info_t.status) == 1
    assert int(info_t.iterations) == int(info_j.iterations)
    assert _rel(u_t.numpy(), u_j) <= 1e-10
    it = int(info_t.iterations)
    h_j = np.asarray(info_j.history)[:it + 1]
    np.testing.assert_allclose(info_t.history[:it + 1].numpy(), h_j,
                               rtol=1e-6, atol=1e-9 * h_j[0])
    # deterministic: a second solve is bitwise the first
    u_t2, info_t2 = tf.pcg(torch.as_tensor(bn), tol=1e-12, max_iter=2000)
    assert torch.equal(u_t, u_t2)
    assert torch.equal(info_t.history, info_t2.history)


def test_dropped_system_is_freed(box):
    """A system that ran pcg is freed when its last reference goes (its
    PCG block holds it weakly: no cycle keeps it, nor on the card its
    graphs' memory pools)."""
    import gc
    import weakref
    coords, conn, N, fixed, labels, K, b = box
    fem, part = td.build_distributed_fem(
        coords, conn, "c3d4", E, NU, mesh=td.PartMesh(2, device="cpu"),
        fixed_nodes=fixed)
    fem.pcg(part.to_new(torch.as_tensor(b)), tol=0.0, max_iter=3)
    gc.collect()
    gc.disable()
    try:
        ref = weakref.ref(fem)
        del fem
        assert ref() is None
    finally:
        gc.enable()


def test_padding_rows_zero(box, systems):
    coords, conn, N, fixed, labels, K, b = box
    for name in SYSTEMS:
        _, _, tf, tp = systems[name]
        F = tf.spmv(tp.to_new(torch.ones((N, 3), dtype=torch.float64)))
        pad = torch.as_tensor(tp.old_from_new < 0)
        assert pad.any()
        assert torch.equal(F[pad], torch.zeros_like(F[pad]))


def test_halo_matches_allgather(box, systems):
    """The two schemes agree (same labels, same numbering), and the halo
    moves fewer rows than the all-gather."""
    coords, conn, N, fixed, labels, K, b = box
    _, _, tf_d, tp_d = systems["dist"]
    _, _, tf_h, tp_h = systems["halo"]
    u = torch.as_tensor(np.random.default_rng(3).standard_normal((N, 3)))
    Fd = tp_d.to_old(tf_d.spmv(tp_d.to_new(u)))
    Fh = tp_h.to_old(tf_h.spmv(tp_h.to_new(u)))
    assert _rel(Fh.numpy(), Fd.numpy()) <= 1e-13
    m = tp_h.meta
    assert len(m.rounds) * m.halo_width < m.n_parts * m.block_rows


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_part_counts_agree(name):
    """2- and 8-part solves agree to roundoff (not bitwise), as tpufem's
    test_distributed_different_part_counts_agree holds it."""
    coords, conn = meshgen.box_tet(2, 2, 4)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 1] = 0.5
    build = SYSTEMS[name][1]
    sols = []
    for nparts in (2, 8):
        fem, part = build(coords, conn, "c3d4", E, NU,
                          mesh=td.PartMesh(nparts, device="cpu"),
                          fixed_nodes=fixed)
        u, info = fem.pcg(part.to_new(torch.as_tensor(b)), tol=1e-12,
                          max_iter=3000)
        assert int(info.status) == 1
        sols.append(part.to_old(u).numpy())
    np.testing.assert_allclose(sols[0], sols[1], rtol=1e-8, atol=1e-12)


def test_part_mesh_collectives():
    """PartMesh's collectives on a 3-part mesh: all_gather tiles, the
    reduce_scatter sums in ascending part order, ppermute gives zeros to
    parts outside the round, psum sums the [P] partials."""
    mesh = td.PartMesh(3, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 2, 3, dtype=torch.float64, generator=g)
    full = mesh.all_gather(x)
    assert full.shape == (3, 6, 3)
    for p in range(3):
        assert torch.equal(full[p], x.reshape(6, 3))
    y = torch.randn(3, 6, 3, dtype=torch.float64, generator=g)
    rs = mesh.reduce_scatter(y)
    for p in range(3):
        blk = [y[q, 2 * p:2 * p + 2] for q in range(3)]
        assert torch.equal(rs[p], (blk[0] + blk[1]) + blk[2])
    got = mesh.ppermute(x, ((0, 2), (2, 1)))
    assert torch.equal(got[2], x[0]) and torch.equal(got[1], x[2])
    assert torch.equal(got[0], torch.zeros_like(x[0]))
    s = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert float(mesh.psum(s)) == 6.0
    m2 = td.make_mesh_2d((2, 3), device="cpu")
    assert m2.n_parts == 6 and m2.part_shape == (2, 3)
    with pytest.raises(ValueError):
        td.PartMesh(4, device="cpu", part_shape=(2, 3))


def test_group_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        td.GroupMesh(device="cpu")
