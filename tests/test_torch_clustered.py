"""tpufem_torch's clustered operator and its kernels K7a/K7b against tpufem.

* ClusterPlan tables (l2g, lconn and the combine tables) are bitwise equal
  to tpufem's, with the automatic cluster size and with a given one;
* the plain cluster_expand is bitwise equal to tpufem's Pallas kernel in
  interpret mode; the plain cluster_compress sums each slot in lane order
  while tpufem's one-hot dot sums in its own order, so the two agree to
  <= 1e-12 relative in f64 (bitwise on integer-valued lanes, whose sums
  are exact in any order);
* slot_lists, the compress kernel's index arithmetic, lists every (slot,
  lane) pair once, lanes ascending, and a compress through its lists is
  bitwise the plain cluster_compress;
* ClusteredOperator (apply and diagonal) on tpufem's K carried across
  agrees with tpufem's ClusteredOperator and with the port's
  MatrixFreeOperator to <= 1e-12 relative in f64 (max-norm);
* with 1, 2 or 6 values per node (a seeded symmetric K of that size), it
  agrees with tpufem's ClusteredOperator (its one-hot path) to <= 1e-12
  relative in f64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements import solid as js
from tpufem.ops import clustered as j_cl
from tpufem.ops import pallas_kernels as jpk
from tpufem.utils import meshgen

from tpufem_torch.ops import cluster_kernels as tck
from tpufem_torch.ops import clustered as t_cl
from tpufem_torch.ops import operator as t_op
from tpufem_torch.ops import scatter as t_scatter

E, NU = 200e9, 0.3
CASES = {"c3d10": ("box_tet10", (3, 3, 3), 0),
         "c3d4-ec24": ("box_tet", (3, 3, 4), 24),
         "c3d8": ("box_hex", (4, 3, 3), 0)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    gen, dims, ec = CASES[request.param]
    etype = request.param.split("-")[0]
    coords, conn = getattr(meshgen, gen)(*dims)
    N = coords.shape[0]
    jp = j_cl.ClusterPlan.build(conn, N, 3, elems_per_cluster=ec)
    tp = t_cl.ClusterPlan.build(conn, N, 3, elems_per_cluster=ec,
                                device="cpu")
    K = np.asarray(js.stiffness(jnp.asarray(coords), jnp.asarray(conn),
                                etype, E, NU))
    u = np.random.default_rng(11).standard_normal((N, 3))
    return dict(conn=conn, N=N, jp=jp, tp=tp, K=K, u=u)


def test_cluster_plan_bitwise(case):
    jp, tp = case["jp"], case["tp"]
    m = jp.meta
    assert (tp.n_clusters, tp.elems_per_cluster, tp.l_max) == (
        m.n_clusters, m.elems_per_cluster, m.l_max)
    for name in ("l2g", "lconn"):
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    jc, tc = jp.combine, tp.combine
    assert jc.meta.pack == 1 and not jc.meta.chunked
    assert tc.widths == jc.meta.class_widths
    for a, b in zip(jc.inc, tc.inc):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jc.inv_order), tc.inv_order.numpy())


@pytest.fixture(scope="module")
def kernel_case():
    """One interpret-mode call per kernel (box_tet10(3), f64)."""
    coords, conn = meshgen.box_tet10(3, 3, 3)
    jp = j_cl.ClusterPlan.build(conn, coords.shape[0], 3)
    B = jp.meta.n_clusters
    lc = np.array(jp.lconn).reshape(B, -1)
    rng = np.random.default_rng(12)
    Uc = rng.standard_normal((B, 128, 3))
    Fe = rng.standard_normal((B, lc.shape[1], 3))
    Fe_int = rng.integers(-64, 64, Fe.shape).astype(np.float64)
    return dict(lc=lc, Uc=Uc, Fe=Fe, Fe_int=Fe_int,
                Yc_int=np.asarray(jpk.cluster_compress(jnp.asarray(lc),
                                                       jnp.asarray(Fe_int),
                                                       128, interpret=True)),
                ue=np.asarray(jpk.cluster_expand(jnp.asarray(lc),
                                                 jnp.asarray(Uc),
                                                 interpret=True)),
                Yc=np.asarray(jpk.cluster_compress(jnp.asarray(lc),
                                                   jnp.asarray(Fe), 128,
                                                   interpret=True)))


def test_cluster_expand_plain_bitwise(kernel_case):
    kc = kernel_case
    got = tck.cluster_expand(torch.from_numpy(kc["lc"]),
                             torch.from_numpy(kc["Uc"]))
    assert np.array_equal(got.numpy(), kc["ue"])


def test_cluster_compress_plain(kernel_case):
    kc = kernel_case
    got = tck.cluster_compress(torch.from_numpy(kc["lc"]),
                               torch.from_numpy(kc["Fe"]), 128)
    assert got.shape == kc["Yc"].shape and _rel(got, kc["Yc"]) <= 1e-12
    # the plain version's order: lanes ascending from 0, exactly
    lc, Fe = kc["lc"], kc["Fe"]
    want = np.zeros_like(kc["Yc"])
    for b in range(lc.shape[0]):
        for r in range(lc.shape[1]):
            want[b, lc[b, r]] += Fe[b, r]
    assert np.array_equal(got.numpy(), want)


def _list_case(kernel_case, name):
    """(lconn, L) for the list tests: the plan's, and edge cases."""
    rng = np.random.default_rng(14)
    if name == "plan":
        return kernel_case["lc"], 128
    if name == "one-slot":                      # every lane in one slot
        return np.full((2, 320), 7, np.int32), 128
    if name == "ragged":                        # R % 32 != 0, L < 128
        return rng.integers(0, 5, (3, 45)).astype(np.int32), 5
    return (rng.integers(0, 40, (2, 70)) * 3).astype(np.int32), 128


def _compress_through_lists(lconn, Fe, L):
    """Slot sums in the kernel's order: each slot's list from 0."""
    start, lanes = tck.slot_lists(lconn, L)
    B, R, nd = Fe.shape
    out = Fe.new_zeros((B, L, nd))
    cnt = start[:, 1:] - start[:, :-1]
    bidx = torch.arange(B)[:, None]
    for j in range(int(cnt.max())):
        r = lanes.gather(1, (start[:, :-1] + j).clamp(max=R - 1))
        out = torch.where((cnt > j)[..., None], out + Fe[bidx, r], out)
    return out


LIST_CASES = ["plan", "one-slot", "ragged", "empty-slots"]


@pytest.mark.parametrize("name", LIST_CASES)
def test_slot_lists(kernel_case, name):
    lc, L = _list_case(kernel_case, name)
    start, lanes = tck.slot_lists(torch.from_numpy(lc), L)
    B, R = lc.shape
    counts = np.stack([np.bincount(row, minlength=L) for row in lc])
    assert np.array_equal(start[:, 0].numpy(), np.zeros(B))
    assert np.array_equal(np.diff(start.numpy(), axis=1), counts)
    assert np.array_equal(np.sort(lanes.numpy(), axis=1),
                          np.broadcast_to(np.arange(R), (B, R)))
    for b in range(B):
        for l in range(L):
            seg = lanes[b, start[b, l]:start[b, l + 1]].numpy()
            assert np.array_equal(seg, np.flatnonzero(lc[b] == l))


@pytest.mark.parametrize("name", LIST_CASES)
def test_compress_through_slot_lists(kernel_case, name):
    lc, L = _list_case(kernel_case, name)
    lt = torch.from_numpy(lc)
    Fe = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (*lc.shape, 3)))
    got = _compress_through_lists(lt, Fe, L)
    assert torch.equal(got, tck.cluster_compress_plain(lt, Fe, L))
    if name == "plan":
        kc = kernel_case
        Fe_int = torch.from_numpy(kc["Fe_int"])
        assert np.array_equal(_compress_through_lists(lt, Fe_int, L).numpy(),
                              kc["Yc_int"])
        assert _rel(_compress_through_lists(
            lt, torch.from_numpy(kc["Fe"]), L), kc["Yc"]) <= 1e-12


def test_cluster_spmv(kernel_case):
    kc = kernel_case
    B, R = kc["lc"].shape
    K = np.random.default_rng(13).standard_normal((B, R // 10, 30, 30))
    want = jpk.cluster_spmv(jnp.asarray(K), jnp.asarray(kc["lc"]),
                            jnp.asarray(kc["Uc"]), interpret=True)
    got = tck.cluster_spmv(torch.from_numpy(K), torch.from_numpy(kc["lc"]),
                           torch.from_numpy(kc["Uc"]))
    assert _rel(got, want) <= 1e-12


def test_clustered_operator(case):
    jp, tp, K, u = case["jp"], case["tp"], case["K"], case["u"]
    jop = j_cl.ClusteredOperator.build(jnp.asarray(K), case["conn"],
                                       case["N"], 3, plan=jp)
    top = t_cl.ClusteredOperator.build(K, case["conn"], case["N"], 3,
                                       plan=tp)
    ut = torch.from_numpy(u)
    F = top(ut)
    assert _rel(F, jop(jnp.asarray(u))) <= 1e-12
    assert _rel(top.diagonal(), jop.diagonal()) <= 1e-12
    mf = t_op.MatrixFreeOperator(
        K, t_scatter.ScatterPlan.build(case["conn"], case["N"], 3,
                                       device="cpu"))
    assert _rel(F, mf(ut).numpy()) <= 1e-12
    assert _rel(top.diagonal(), mf.diagonal().numpy()) <= 1e-12


def test_clustered_plan_from_tpufem_arrays(case):
    jp, tp = case["jp"], case["tp"]
    jc = jp.combine
    comb = t_scatter.CombinePlan.from_arrays(
        [np.asarray(a) for a in jc.inc], jc.meta.class_widths,
        np.asarray(jc.inv_order), jc.meta.n_rows, device="cpu")
    fp = t_cl.ClusterPlan.from_arrays(np.asarray(jp.l2g),
                                      np.asarray(jp.lconn), comb,
                                      jp.meta.n_nodes, 3, device="cpu")
    op1 = t_cl.ClusteredOperator.build(case["K"], None, case["N"], plan=fp)
    op2 = t_cl.ClusteredOperator.build(case["K"], None, case["N"], plan=tp)
    ut = torch.from_numpy(case["u"])
    assert torch.equal(op1(ut), op2(ut))


@pytest.mark.parametrize("nd", [1, 2, 6])
def test_clustered_operator_dof_per_node(nd):
    """Repair: any dof_per_node (the kernels K7a and K7b take 1 to 6)."""
    coords, conn = meshgen.box_tet(3, 3, 2)
    N, (M, k) = coords.shape[0], conn.shape
    d = k * nd
    A = np.random.default_rng(16 + nd).standard_normal((M, d, d))
    K = A + A.transpose(0, 2, 1)
    u = np.random.default_rng(17).standard_normal((N, nd))
    jop = j_cl.ClusteredOperator.build(jnp.asarray(K), conn, N, nd)
    top = t_cl.ClusteredOperator.build(K, conn, N, nd, device="cpu")
    assert top.plan.dof_per_node == nd
    assert _rel(top(torch.from_numpy(u)), jop(jnp.asarray(u))) <= 1e-12
    assert _rel(top.diagonal(), jop.diagonal()) <= 1e-12
