"""tpufem_torch's HaloPartialFEM (parallel.halo_partial) on a PartMesh
against tpufem's on its 8-device CPU mesh.

_color_rounds and every partition table are bitwise tpufem's (the
incidence less tpufem's bins of the padding elements' zero rows); the
geometry factors agree to 1e-14 relative (max-norm; the port's jacobian
einsum and XLA's add the same ten products in another order: 2.6e-15
measured); the spmv agrees with tpufem's jitted spmv to rtol 1e-12 (f64)
at box_tet10(3, 3, 4), 8 parts, part_shape=(2, 4); the PCG ends in
tpufem's count with u within 1e-10.  Also: serialize_exchange gives the
same bits, two runs are bitwise, 2 and 4 parts agree, the interior split
and the memory model.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.parallel import dist as jd
from tpufem.parallel import halo_partial as jhp
from tpufem.parallel.partition import (hierarchical_partition,
                                       partition_elements)
from tpufem.utils import meshgen

from tpufem_torch.parallel import dist as td
from tpufem_torch.parallel import halo_partial as thp

E, NU = 200e9, 0.3
TABLES = ("conn_local", "send_idx", "recv_slot", "recv_mask",
          "new_from_old", "old_from_new")


def _same_inc(jp, tp, labels):
    """tpufem's inc also bins the padding elements' rows (zero W) into
    node 0's bin; the port's is tpufem's with those entries set to the
    fill and the table cut to its own width."""
    m = tp.meta
    k = m.nodes_per_elem
    fill = m.elems_per_part * k
    n_real = np.bincount(labels, minlength=m.n_parts) * k
    ji = np.asarray(jp.inc)
    ji = np.where(ji < n_real[:, None, None], ji, fill).astype(ji.dtype)
    W = tp.inc.shape[2]
    assert (ji[:, :, W:] == fill).all()
    _same(ji[:, :, :W], tp.inc)


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


def _curve(coords):
    c = coords.copy()
    c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
    return c


def _to_new(part, u):
    m = part.meta
    out = np.zeros((m.n_parts * m.block_rows, u.shape[1]), u.dtype)
    out[np.asarray(part.new_from_old)] = u
    return out


def test_color_rounds_bitwise():
    rng = np.random.default_rng(0)
    for _ in range(20):
        P = int(rng.integers(2, 12))
        pairs = sorted({(int(s), int(d)) for s, d in
                        rng.integers(0, P, (3 * P, 2)) if s != d})
        w = [int(x) for x in rng.integers(1, 5, len(pairs))]
        assert thp._color_rounds(pairs, w) == jhp._color_rounds(pairs, w)
    assert thp._color_rounds([], []) == jhp._color_rounds([], []) == []


CASES = {
    "flat": (lambda: meshgen.box_tet10(3, 3, 4), "c3d10", None, False),
    "2x4": (lambda: meshgen.box_tet10(3, 3, 4), "c3d10", (2, 4), False),
    "curved": (lambda: meshgen.box_tet10(3, 3, 4), "c3d10", None, True),
    "c3d4": (lambda: meshgen.box_tet(5, 4, 4), "c3d4", (2, 4), False),
}


def _labels(conn, etype, shape):
    if shape is None:
        return partition_elements(conn, etype, 8, 0)[0]
    return hierarchical_partition(conn, etype, shape, 0)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_tables_bitwise(case):
    mesh, etype, shape, curve = CASES[case]
    coords, conn = mesh()
    if curve:
        coords = _curve(coords)
    labels = _labels(conn, etype, shape)
    jp = jhp.HaloPartialPartition.build(coords, conn, etype, E, NU, labels,
                                        8, part_shape=shape)
    tp = thp.HaloPartialPartition.build(coords, conn, etype, E, NU, labels,
                                        8, part_shape=shape, device="cpu")
    for t in TABLES:
        _same(getattr(jp, t), getattr(tp, t))
    _same_inc(jp, tp, labels)
    assert dataclasses.astuple(jp.meta) == dataclasses.astuple(tp.meta)
    assert jp.dN == tp.dN
    assert tp.meta.n_qj == (4 if curve else 1)
    for g in ("Jinv", "W"):
        a, b = np.asarray(getattr(jp, g)), getattr(tp, g).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(b, a) <= 1e-14, g


@pytest.fixture(scope="module")
def hier():
    """box_tet10(3, 3, 4), part_shape=(2, 4), fixed z = 0, Jacobi: both
    packages."""
    coords, conn = meshgen.box_tet10(3, 3, 4)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    jf, jp = jhp.build_halo_partial_fem(
        coords, conn, "c3d10", E, NU, mesh=jd.make_mesh_2d((2, 4)),
        part_shape=(2, 4), fixed_nodes=fixed)
    tf, tp = thp.build_halo_partial_fem(
        coords, conn, "c3d10", E, NU,
        mesh=td.make_mesh_2d((2, 4), device="cpu"), part_shape=(2, 4),
        fixed_nodes=fixed)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 0] = 1e3
    return coords, conn, N, jf, jp, tf, tp, b


def test_spmv_and_jacobi_match_tpufem(hier):
    coords, conn, N, jf, jp, tf, tp, b = hier
    u = np.random.default_rng(2).standard_normal((N, 3))
    un = _to_new(jp, u)
    F_j = np.asarray(jf.spmv(jnp.asarray(un)))
    F_t = tf.spmv(torch.as_tensor(un)).numpy()
    np.testing.assert_allclose(F_t, F_j, rtol=1e-12,
                               atol=1e-12 * np.abs(F_j).max())
    np.testing.assert_allclose(tf.M_inv.numpy(), np.asarray(jf.M_inv),
                               rtol=1e-12, atol=0)
    _same(jf.free_mask, tf.free_mask)


def test_pcg_matches_tpufem(hier):
    coords, conn, N, jf, jp, tf, tp, b = hier
    bn = _to_new(jp, b)
    tol = 1e-10 * float(np.linalg.norm(b))
    u_j, info_j = jf.pcg(jnp.asarray(bn), tol=tol, max_iter=3000)
    u_t, info_t = tf.pcg(torch.as_tensor(bn), tol=tol, max_iter=3000)
    assert int(info_j.status) == int(info_t.status) == 1
    assert int(info_t.iterations) == int(info_j.iterations)
    assert _rel(u_t.numpy(), np.asarray(u_j)) <= 1e-10


def test_serialized_exchange_and_determinism(hier):
    """serialize_exchange changes only which rows the interior batch reads
    (the same values): bitwise the same apply; two applies bitwise."""
    coords, conn, N, jf, jp, tf, tp, b = hier
    u = torch.as_tensor(np.random.default_rng(5).standard_normal((N, 3)))
    un = tp.to_new(u)
    ser = thp.HaloPartialFEM(tf.mesh, tf.axis, tp, serialize_exchange=True)
    F1, F2 = tf.spmv(un), tf.spmv(un)
    assert torch.equal(F1, F2)
    assert torch.equal(ser.spmv(un), F1)


def test_part_counts_agree():
    coords, conn = meshgen.box_tet10(2, 2, 2)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 1] = 1e3
    sols = []
    for nparts in (2, 4):
        fem, part = thp.build_halo_partial_fem(
            coords, conn, "c3d10", E, NU,
            mesh=td.PartMesh(nparts, device="cpu"), fixed_nodes=fixed)
        u, info = fem.pcg(part.to_new(torch.as_tensor(b)),
                          tol=1e-8 * float(np.linalg.norm(b)),
                          max_iter=3000)
        assert int(info.status) == 1
        sols.append(part.to_old(u).numpy())
    np.testing.assert_allclose(sols[0], sols[1], rtol=1e-7,
                               atol=1e-10 * np.abs(sols[1]).max())


def test_interior_split_and_memory_model():
    """On box_tet(10, 10, 10) in 2 parts the interior batch is the
    majority of each part, tpufem's cut, and reads owned rows only; each
    element stores at most 160 B of geometry (qJ * 9 + q floats)."""
    coords, conn = meshgen.box_tet(10, 10, 10)
    labels, _ = partition_elements(conn, "c3d4", 2, 0)
    tp = thp.HaloPartialPartition.build(coords, conn, "c3d4", E, NU, labels,
                                        2, device="cpu")
    jp = jhp.HaloPartialPartition.build(coords, conn, "c3d4", E, NU, labels,
                                        2)
    m = tp.meta
    assert m.interior_cut == jp.meta.interior_cut
    assert m.interior_cut > 0.5 * int(np.bincount(labels, minlength=2).min())
    assert tp.conn_local[:, :m.interior_cut].max() < m.block_rows
    _same(jp.conn_local, tp.conn_local)
    _same_inc(jp, tp, labels)
    assert tuple(tp.Jinv.shape) == (2, m.elems_per_part, m.n_qj, 9)
    assert (m.n_qj * 9 + m.n_q) * tp.W.element_size() <= 160
