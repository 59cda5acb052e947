"""tpufem_torch's scatter plans and assembled-stiffness operator against
tpufem.

* ScatterPlan and CombinePlan tables are bitwise equal to tpufem's (c3d10,
  c3d4 and c3d8 box meshes, whose node valences fill several width
  classes);
* gather is bitwise; scatter and scatter_sorted sum the same entries in
  another order than XLA, so they agree to <= 1e-12 relative in f64;
* MatrixFreeOperator (apply and diagonal), nodal_forces,
  diagonal_preconditioner and block_operator, on tpufem's K carried
  across, agree to <= 1e-12 relative in f64 (max-norm).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import operator as j_op
from tpufem.ops import scatter as j_scatter
from tpufem.elements import solid as js
from tpufem.utils import meshgen

from tpufem_torch.ops import operator as t_op
from tpufem_torch.ops import scatter as t_scatter

E, NU = 200e9, 0.3
MESHES = {"c3d10": ("box_tet10", (3, 2, 2)), "c3d4": ("box_tet", (3, 3, 2)),
          "c3d8": ("box_hex", (3, 2, 4))}


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


@pytest.fixture(scope="module", params=list(MESHES))
def case(request):
    """Both packages' plans on one mesh, tpufem's K and a seeded u."""
    etype = request.param
    gen, dims = MESHES[etype]
    coords, conn = getattr(meshgen, gen)(*dims)
    N = coords.shape[0]
    jp = j_scatter.ScatterPlan.build(conn, N, 3)
    tp = t_scatter.ScatterPlan.build(conn, N, 3, device="cpu")
    K = np.asarray(js.stiffness(jnp.asarray(coords), jnp.asarray(conn),
                                etype, E, NU))
    u = np.random.default_rng(3).standard_normal((N, 3))
    return dict(etype=etype, conn=conn, N=N, jp=jp, tp=tp, K=K, u=u)


def test_plan_tables_bitwise(case):
    jp, tp = case["jp"], case["tp"]
    for name in ("conn", "dofs", "perm", "segments"):
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    jc, tc = jp.combine, tp.combine
    assert jc.meta.pack == 1 and not jc.meta.chunked
    assert tc.widths == jc.meta.class_widths and len(tc.widths) > 1
    for a, b in zip(jc.inc, tc.inc):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jc.inv_order), tc.inv_order.numpy())
    assert (tp.n_dof, tp.n_nodes, tp.n_rows) == (
        jp.meta.n_dof, jp.meta.n_nodes, jp.meta.n_rows)


def test_plan_from_tpufem_arrays(case):
    jp, tp = case["jp"], case["tp"]
    jc = jp.combine
    comb = t_scatter.CombinePlan.from_arrays(
        [np.asarray(a) for a in jc.inc], jc.meta.class_widths,
        np.asarray(jc.inv_order), jc.meta.n_rows, device="cpu")
    fp = t_scatter.ScatterPlan.from_arrays(
        np.asarray(jp.conn), np.asarray(jp.dofs), np.asarray(jp.perm),
        np.asarray(jp.segments), comb, jp.meta.n_nodes, 3, device="cpu")
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (case["conn"].shape[0], case["conn"].shape[1] * 3)))
    assert torch.equal(fp.scatter(v), tp.scatter(v))


def test_gather_scatter(case):
    jp, tp = case["jp"], case["tp"]
    u = case["u"]
    assert np.array_equal(tp.gather(torch.from_numpy(u.reshape(-1))).numpy(),
                          np.asarray(jp.gather(jnp.asarray(u.reshape(-1)))))
    assert np.array_equal(tp.gather_nodes(torch.from_numpy(u)).numpy(),
                          np.asarray(jp.gather_nodes(jnp.asarray(u))))
    v = np.random.default_rng(5).standard_normal(
        (case["conn"].shape[0], case["conn"].shape[1] * 3))
    want = np.asarray(jp.scatter(jnp.asarray(v)))
    got = tp.scatter(torch.from_numpy(v))
    assert _rel(got, want) <= 1e-12
    assert _rel(tp.scatter_sorted(torch.from_numpy(v)), want) <= 1e-12
    # f32: the same sums in float32
    got32 = tp.scatter(torch.from_numpy(v.astype(np.float32)))
    assert got32.dtype == torch.float32 and _rel(got32, want) <= 1e-6


def test_matrix_free_operator(case):
    jp, tp, K, u = case["jp"], case["tp"], case["K"], case["u"]
    jop = j_op.MatrixFreeOperator(K=jnp.asarray(K), plan=jp)
    top = t_op.MatrixFreeOperator(K, tp)
    assert top.K.dtype == torch.float64
    ut = torch.from_numpy(u)
    assert _rel(top(ut), jop(jnp.asarray(u))) <= 1e-12
    assert _rel(top.diagonal(), jop.diagonal()) <= 1e-12
    assert _rel(t_op.nodal_forces(top.K, case["conn"], ut),
                j_op.nodal_forces(jnp.asarray(K), jp, jnp.asarray(u))) <= 1e-12
    Mj = j_op.diagonal_preconditioner([jop, jop])
    Mt = t_op.diagonal_preconditioner([top, top])
    assert Mt.shape == (case["N"], 3) and _rel(Mt, Mj) <= 1e-12
    Fj = j_op.block_operator([jop, jop])(jnp.asarray(u))
    Ft = t_op.block_operator([top, top])(ut)
    assert _rel(Ft, Fj) <= 1e-12
